#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multiverso_tpu_torch``) on one
CUDA card.

Phases, each fatal on failure:

1. build the nineteen hand-written kernels from ``multiverso_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) and print the build
   time and ``ptxas`` resource usage;
2. set up the main path at the benchmark's full width: the synthetic
   corpus of ``bench.py`` (``models/wordembedding/synthetic.py``, ~6M
   tokens, ~1M-word dictionary), ``mv.init([])`` on ``cuda:0``,
   ``PSWord2Vec`` (D=128, window 5, 5 negatives, neg_block 8) over two
   ~1M-row matrix tables, ``PSDeviceCorpusTrainer`` with 32768 centers a
   block;
3. hold every kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (the corpus for K1, block 0's ids
   into both tables for K2-K4; K3 bit-exact on deltas rounded to a grid
   on which every sum is exact in any order), and time kernel, plain
   version and — where one PyTorch call computes the same function —
   that call, with torch.profiler; also K4 and K5 with a negative block
   wider than a thread block, at a small width;
4. drive the main path — ``train_epoch`` for 8 blocks through the worker
   and server actors — with every launch count set to 0 just before and
   read just after; every kernel must have launched;
5. check the result: finite losses and rows of the right shapes, and the
   same small input (the topic corpus of the tests) trained on the card
   and on the CPU with the same draws agreeing per block;
6. the local pipeline (``Word2Vec`` + ``DeviceCorpusTrainer``, tables
   whole on the card) on the same corpus, with the PS tables freed
   first, in the five modes of the reference's bench: skip-gram and
   CBOW with negative sampling (16384 centers a step, 16 steps a group,
   neg_block 8), skip-gram and CBOW with hierarchical softmax (8192, 8)
   and the per-pair quality mode (2048, 32). For each mode: every
   kernel of its path against its plain version at step 0's shapes,
   timed as in phase 3 (K1 on the epoch's uniforms, K2 on the step's
   ids, the step kernel K4-K8, K3 scattering its gradients);
   2 groups of steps with the launch counts reset just before and read
   just after (K1, K2, K3 and the step kernel must launch), words/s on
   the host clock; the same steps under ``torch.profiler`` (device ms a
   step, the card's busy share); finite losses; and the topic corpus
   trained on the card and on the CPU with the same draws, loss and
   both tables agreeing;
7. the PS device pipeline's other configurations, each under its own
   ``mv.init``: CBOW (32768 centers a block, neg_block 8), HS skip-gram
   and HS CBOW (32768, within ``_hs_center_cap``), the per-pair quality
   mode (2048 centers, 4 blocks a dispatch) and SGNS at 8 blocks a
   dispatch: as phase 6 per path (K1 and the step kernel against their
   plain versions at block 0's call, K2 and K3 at the first dispatch's
   pulls and pushes — all G blocks' ids, the per-pair mode's band and
   all its negatives; max(2G, 8) blocks counted, then profiled; finite
   tables), and the topic corpus trained on the card and on the CPU
   with the same draws;
8. the host-batch trainer (``-device_pipeline=false``) in all four modes,
   locally (``Word2Vec``, batches of 32768 pairs launched one by one) and
   through the parameter server (``PSWord2Vec``, batches of 131072,
   neg_block 8, pipelined behind a ``BlockLoader``): K9 or K10 against
   its plain version at the first batch's ids over random tables, timed
   beside its bound, with K2 (the PS pulls) and K3 (its gradients; on
   the PS path also the server's add of the delta buffers);
   2 warm-up batches, then 16 batches locally or 4 through the PS
   counted and profiled (words/s, the card's busy share; every
   kernel of the path must launch); finite tables; the topic corpus
   trained on the card and on the CPU with the same draws;
9. the logistic-regression app on a seeded synthetic corpus with the
   widths of the LIBSVM ``criteo`` set (1,000,000 hashed features, 39
   nonzeros a sample: 13 numeric fields with log-scaled values and 26
   Zipf-skewed categorical ones with value 1; labels from a planted
   weight vector), in batches of 4096: K11 and K12 against their plain
   versions at the first batch's shapes (K11 within a tolerance, K12 bit
   for bit on values and diffs rounded to a grid where every sum is
   exact; also softmax at C=10, L1 and keys repeated within a sample),
   then four sparse paths — ``lr_sparse_local`` (``LocalModel``,
   sigmoid, L2, sgd), ``lr_ftrl_local`` (``FTRLModel``),
   ``lr_sparse_ps`` (``PSModel`` over a sparse matrix table, with K2 and
   K3 checked where its server runs them) and ``lr_ftrl_ps`` (two array
   tables) — and ``lr_dense_ps`` (the mnist.config widths, torch only),
   each 4 warm-up batches and 64 counted (samples/s, every kernel of
   the path launched, finite losses) and profiled (device ms a batch,
   busy share); the tests' small sets trained on the card and on the
   CPU in six model families (losses, correct counts and weights at
   rtol 1e-4 / atol 1e-6); and the CLI
   ``python -m multiverso_tpu_torch.models.logreg.main <config>``, train
   + test on a 50,000-sample libsvm file;
10. the table data plane, as the reference's table benchmark drives it
   (``bench.py`` ``matrix_bandwidth``: 1,000,000 x 50 float32 tables,
   every 10th row dirty, 100,000 a round padded to 131,072 ids): K13
   under each stateful rule and K14 under default (bit for bit on
   grid-rounded deltas) and each stateful rule against their plain
   versions (also with 5% duplicate ids, wrapped and out-of-range ids,
   one row at 4,096 positions and a worker past the state's slots; rtol
   1e-5 / atol 1e-7; the row at 4,096 positions, whose steps of both
   signs cancel, against the plain version on the CPU, which adds in
   position order as K13 and K14 do), K2 and K3 at C=50, each timed on
   5 sets of rows in turn (no call finds its rows in L2); then the
   paths,
   each 2 warm-up and 10 counted rounds (ms a round, the bench's GB/s,
   every kernel launched, the last round checked against a shadow
   table) and profiled (device ms a round, busy share): ``tbl_dense``
   (whole-table adds of a device delta, then ``get_device``),
   ``tbl_dirty_default`` (``add_rows`` + ``get_dirty_device``: K3, K2),
   ``tbl_fused_default`` (``add_get_dirty_device`` with a device mirror
   of the ids: K14), and ``tbl_dirty_<rule>`` (K13, K2) and
   ``tbl_fused_<rule>`` (K14, host ids) for momentum, adagrad and
   dcasgd on a pipelined table; finally the tests' small op sequence
   under each rule on the card and on the CPU (ids equal, values,
   tables and state within rtol 1e-4 / atol 1e-6);
11. several servers in one process: the main path (PS SGNS at phase 2's
   settings) over ``LocalCluster(n, roles=["all"] + ["server"] * (n -
   1), device="cuda:0")`` — ``ps_2srv`` and ``ps_4srv`` with the device
   keys broadcast to every server (K1, K15 ``row_gather_bounded``, K4,
   K16 ``row_scatter_add_bounded``), ``ps_2srv_seg`` and
   ``ps_4srv_seg`` with ``segment_keys=True`` (also K18
   ``segment_split`` and K17 ``segment_merge``): every kernel of the
   path against its plain version, bit for bit (K16 on grid-rounded
   deltas), at blocks 0-4's ids on every server's window plus each
   window's edge ids, timed over a block's calls with the 5 blocks'
   rows in turn; 8 blocks counted (launches summed over the servers,
   words/s) and profiled; finite tables; and the topic corpus through
   the same cluster shape on the card and on the CPU with the same
   draws (rtol 1e-4 / atol 1e-6);
12. model averaging (B16): ``ma_mesh4``, the device MA group
   (``_ma_group_fn``) on ``local_mesh(4)`` — four replica slots of the
   one card — at the local SGNS settings (16384 centers a step, 16
   steps a group, neg_block 8): the epoch's kept stream (K1) split
   evenly over the slots, each slot's steps on its replica (K2, K4, K3),
   then K19 ``mesh_allreduce``'s mean of the replicas; K1, K2, K4 and K3
   against their plain versions at slot 0's first step, K19 bit for
   bit at the path's shape in both forms (the mean to one copy, the sum
   to four), timed beside ``x.mean(0)`` / ``torch.sum(x, 0)``; 1 warm-up
   and 4 counted groups (raw words/s of all slots, then profiled:
   device ms a group, K19's share); finite tables; the reference
   test's small MA group (8 slots) on the card and on the CPU with the
   same draws. ``ma_sgd4``: ``MASGDStep`` on four slots, the reference
   test's regression (y = 2x, 60 steps) to |w - 2| < 1e-2, loss < 1e-3,
   w within 1e-6 of the CPU's, K19 launched. ``ma_ranks``:
   ``MACorpusTrainer`` over ``LocalCluster(2, argv=["-ma=true"],
   device="cuda:0")``, half the corpus a rank, 8 groups of 16 steps
   averaged every 4, with ``overlap=False``, ``overlap=True``, then
   ``overlap=False`` again (words/s, ``MA_COMM_STALL``, the host's peak
   memory): the two modes apply the same average at the same point, but
   K3's float atomics make the card's local steps vary from run to run,
   so each rank's final tables must differ between sync and overlap by
   no more than 10x what the two sync runs differ (bit-identical when
   those are; the CPU tests hold the modes bit-identical).

Phases 1-6 are as the second slice left them, the small-input checks
now also comparing example counts, and K2 and K3 timed over all the
calls of a step (both tables) instead of the output table's alone. One
Huffman tree of the bench dictionary serves every HS model of the run.

Prints one JSON ``kernels`` line (one entry a path and kernel: ``ps``,
``local_<mode>``, ``ps_<mode>``, ``hb_local_<mode>``, ``hb_ps_<mode>``,
``lr_<path>``, ``tbl_<path>``, ``ps_<n>srv[_seg]``, ``ma_mesh4`` or
``ma_sgd4``, with that path's launches), the card's name and
power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero with
no result when CUDA is not available or the package is missing.

Usage: ``python3 chip_smoke.py`` (one card). ``--profile DIR`` adds a
``torch.profiler`` trace of 8 more blocks (Chrome trace in DIR, the
device's busy share and the host monitors) and keeps the Chrome trace
of every counted path. ``--multiserver-only`` builds the kernels and
runs phase 11 alone (its ``kernels`` line and the card's line, no
result line), ``--ma-only`` phase 12 alike. ``--cpu-rehearsal`` runs
phases 2 and 4-12 at a tiny size
on the CPU with the plain versions (no kernels, no timing, no result
line, exit code 3) to check the control flow on a host without a card.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

DIM, WINDOW, NEG, NEG_BLOCK, CENTERS = 128, 5, 5, 8, 32768
BLOCKS = 8
REPS = 20
PS_KERNELS = ("subsample_compact", "row_gather", "row_scatter_add",
              "banded_sgns_grad")

# The local modes at the reference bench's settings (bench.py:135-149,
# run_local, run_hs): (mode, config flags, centers a step, steps a
# group, step kernel, its source, the JAX program it replaces).
_CSRC = "multiverso_tpu_torch/csrc/"
_REF = "multiverso_tpu/models/wordembedding/device_train.py:"
LOCAL_MODES = (
    ("sgns", dict(neg_block=NEG_BLOCK), 16384, 16, "banded_sgns_grad",
     _CSRC + "banded_sgns.cu", _REF + "131"),
    ("cbow", dict(cbow=True, neg_block=NEG_BLOCK), 16384, 16,
     "banded_cbow_grad", _CSRC + "banded_cbow.cu", _REF + "159"),
    ("hs_sg", dict(hs=True, negative=0), 8192, 8, "banded_hs_sg_grad",
     _CSRC + "banded_hs.cu", _REF + "316"),
    ("hs_cbow", dict(hs=True, cbow=True, negative=0), 8192, 8,
     "hs_cbow_grad", _CSRC + "banded_hs.cu", _REF + "350"),
    ("per_pair", dict(per_pair=True), 2048, 32, "pair_offset_grad",
     _CSRC + "pair_offset.cu", _REF + "233"),
)


# The PS pipeline's other configurations (bench.py:139-151, run_ps and
# run_quality): (path, config flags, centers a block, blocks a dispatch,
# step kernel, its source, the JAX program it replaces).
PS_MODES = (
    ("ps_cbow", dict(cbow=True, neg_block=NEG_BLOCK), CENTERS, 1,
     "banded_cbow_grad", _CSRC + "banded_cbow.cu", _REF + "729"),
    ("ps_hs_sg", dict(hs=True, negative=0), CENTERS, 1,
     "banded_hs_sg_grad", _CSRC + "banded_hs.cu", _REF + "664"),
    ("ps_hs_cbow", dict(hs=True, cbow=True, negative=0), CENTERS, 1,
     "hs_cbow_grad", _CSRC + "banded_hs.cu", _REF + "664"),
    ("ps_per_pair", dict(per_pair=True), 2048, 4, "pair_offset_grad",
     _CSRC + "pair_offset.cu", _REF + "729"),
    ("ps_sgns_g8", dict(neg_block=NEG_BLOCK), CENTERS, 8,
     "banded_sgns_grad", _CSRC + "banded_sgns.cu", _REF + "809"),
)

# The host-batch trainer (-device_pipeline=false): (mode, config flags,
# step kernel, its source); the local form replaces model.py:395
# (_make_step_core), the PS form model.py:755 (_build_ps_step).
_MODEL_REF = "multiverso_tpu/models/wordembedding/model.py:"
HB_MODES = (
    ("sgns", dict(), "pairlist_ns_grad", _CSRC + "pairlist_ns.cu"),
    ("cbow", dict(cbow=True), "pairlist_ns_grad", _CSRC + "pairlist_ns.cu"),
    ("hs_sg", dict(hs=True, negative=0), "pairlist_hs_grad",
     _CSRC + "pairlist_hs.cu"),
    ("hs_cbow", dict(hs=True, cbow=True, negative=0), "pairlist_hs_grad",
     _CSRC + "pairlist_hs.cu"),
)
# (pairs a batch, neg_block, counted batches): bench.py:88 BATCH;
# bench.py:399 HOSTBATCH_SIZE with run_hostbatch's neg_block.
HB_LOCAL = (32768, 1, 16)
HB_PS = (131072, NEG_BLOCK, 4)


def reuse_huffman_trees() -> None:
    """Build each dictionary's Huffman tree once for all the HS models of
    this run (seven on the ~1M-word dictionary, ~13 s a build): the
    port's model module looks ``build_huffman`` up at each call."""
    from multiverso_tpu_torch.models.wordembedding import model
    build, trees = model.build_huffman, {}

    def cached(counts):
        key = (counts.size, hash(counts.tobytes()))
        if key not in trees:
            trees[key] = build(counts)
        return trees[key]

    model.build_huffman = cached


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = REPS, only: str = "") -> float:
    """Device time of one ``fn()`` call: the summed duration of every
    kernel it launches (with ``only``: of the kernels whose name holds
    it), from a ``torch.profiler`` trace of ``reps`` calls after
    warm-up, divided by ``reps``. (CUDA events around a call of a ~20 us
    kernel would also time the Python wrapper's launch.) ``fn`` may be a
    list of calls doing the same work on different inputs: they are
    made in turn, so that a call whose inputs are larger than a share of
    L2 does not find them there."""
    import torch.profiler as tp
    if isinstance(fn, list):
        turn = itertools.cycle(fn)

        def fn():
            return next(turn)()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # A profiler session now and then records no CUDA activity at all
    # (seen once in ~70 sessions of one run); trace such a call again.
    for attempt in range(3):
        with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for evt in prof.key_averages():
            if only in evt.key:
                total_us += float(getattr(evt, "self_device_time_total",
                                          0.0))
        if total_us > 0.0:
            return total_us / reps / 1e3
        log(f"[time] the profiler recorded no device time (trace "
            f"{attempt + 1} of 3)")
    raise RuntimeError("the profiler recorded no device time")


def bound(bytes_moved: float, flops: float = 0.0):
    """(least time in ms, what bounds it) on the published peaks."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bench_corpus(workdir: str, sentences: int):
    """``bench.py``'s synthetic corpus in ``workdir``: (dictionary,
    tokenized corpus)."""
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, TokenizedCorpus, synthetic)
    path = os.path.join(workdir, "corpus.txt")
    synthetic.write_corpus(path, sentences)
    dictionary = Dictionary.build(path, min_count=synthetic.MIN_COUNT)
    return dictionary, TokenizedCorpus.build(dictionary, path)


def setup_main_path(torch, mv, device, workdir: str, sentences: int,
                    centers: int, dim: int):
    """Phase 2: corpus, dictionary, zoo, model and trainer."""
    from multiverso_tpu_torch.models.wordembedding import (
        PSDeviceCorpusTrainer, PSWord2Vec, Word2VecConfig)
    t0 = time.perf_counter()
    dictionary, tokenized = bench_corpus(workdir, sentences)
    t1 = time.perf_counter()
    mv.init([], device=None if device.type == "cuda" else "cpu")
    config = Word2VecConfig(embedding_size=dim, window=WINDOW,
                            negative=NEG, epochs=3, min_count=1,
                            sample=1e-3, use_ps=True, neg_block=NEG_BLOCK)
    model = PSWord2Vec(config, dictionary)
    trainer = PSDeviceCorpusTrainer(model, tokenized, centers)
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"[setup] corpus {tokenized.flat.size} tokens, vocab "
        f"{dictionary.size} words (tables {dictionary.size} x {dim} f32 "
        f"each) | corpus+dictionary {t1 - t0:.1f}s, zoo+tables+trainer "
        f"{time.perf_counter() - t1:.1f}s")
    return model, trainer, dictionary, tokenized


def step0_plan(trainer, u):
    """The trainer's step-kernel work at step (block) 0 of an epoch whose
    subsampling uniforms are ``u``: (sub-steps, pmask) as
    ``device_train._plan`` forms them for either trainer, with fresh
    draws from a generator on the card."""
    from multiverso_tpu_torch.models.wordembedding import device_train
    C, W = trainer._C, trainer.config.window
    kept, ksent, n_kept = trainer._corpus.prep_epoch(u)
    kept_pad, ksent_pad = device_train._pad_stream(C, W, kept, ksent)
    draws = device_train.TorchDraws(trainer.device).step_draws(
        1234, 0, C, W, trainer._neg_shape(), trainer._vocab)
    return device_train._plan(trainer.config, trainer._tables, C,
                              trainer._B, trainer._per_pair, draws,
                              kept_pad, ksent_pad, int(n_kept), 0, -0.025)


def block0_inputs(torch, trainer):
    """The main path's inputs at block 0: K1's uniforms and the first
    block's ids."""
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(1234)
    u = torch.rand(trainer._corpus.n_tokens, generator=gen,
                   device=trainer.device)
    subs, pmask = step0_plan(trainer, u)
    in_ids, out_ids, _, _ = subs[0]
    return u, in_ids, out_ids, pmask


def check_subsample(torch, corpus, u):
    """K1 on the corpus and the epoch's uniforms ``u``: bit-exact."""
    from multiverso_tpu_torch.kernels import subsample
    T = corpus.n_tokens
    V = int(corpus.keep.numel())
    got = subsample.subsample_compact(corpus.flat, corpus.sent, corpus.keep,
                                      u)
    ref = subsample.subsample_compact_plain(corpus.flat, corpus.sent,
                                            corpus.keep, u)
    err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
              for g, r in zip(got, ref))

    def library_partition():
        mask = u < corpus.keep[corpus.flat.to(torch.int64)]
        order = torch.cat([torch.nonzero(mask).reshape(-1),
                           torch.nonzero(~mask).reshape(-1)])
        return corpus.flat[order], corpus.sent[order]

    return dict(
        name="subsample_compact", tol="bit-exact", max_abs_err=float(err),
        ok=err == 0,
        source="multiverso_tpu_torch/csrc/subsample_compact.cu",
        replaces="multiverso_tpu/models/wordembedding/device_train.py:61",
        ms=time_ms(torch, lambda: subsample.subsample_compact(
            corpus.flat, corpus.sent, corpus.keep, u)),
        plain_ms=time_ms(torch, lambda: subsample.subsample_compact_plain(
            corpus.flat, corpus.sent, corpus.keep, u)),
        library_ms=time_ms(torch, library_partition),
        bound=bound(T * 4 * 3 + V * 4 + T * 4 * 2 + 4))


def touched_rows(torch, ids, rows: int) -> int:
    """Distinct table rows that ``ids`` reach: ids in [-rows, -1] wrap;
    every other id out of range (the pad sentinel among them) reads and
    writes no row."""
    flat = ids.reshape(-1).to(torch.int64)
    flat = torch.where(flat < 0, flat + rows, flat)
    return int(torch.unique(flat[(flat >= 0) & (flat < rows)]).numel())


def in_turn(sets, call):
    """One call a set, ``call(*case)`` on each case of the set: the list
    ``time_ms`` takes in turn."""
    return [lambda s=s: [call(*c) for c in s] for s in sets]


def check_gather(torch, cases, D: int, rotate=()):
    """K2 on ``cases``, the step's (table, ids) pairs: bit-exact on
    every pair; timed over all of them, as the step launches them.
    ``rotate``: further case lists of the same shapes on other rows,
    timed in turn with ``cases`` (see ``time_ms``)."""
    from multiverso_tpu_torch.kernels import rows
    err, n_bytes = 0.0, 0
    for table, ids in cases:
        g = rows.row_gather(table, ids, D)
        r = rows.row_gather_plain(table, ids, D)
        err = max(err, float((g - r).abs().max()))
        k = ids.numel()
        n_bytes += k * 4 + touched_rows(torch, ids, table.shape[0]) * D * 4 \
            + k * D * 4
    sets = [list(cases)] + [list(c) for c in rotate]
    # The library call raises on the pad sentinel: clamp it (outside the
    # timed call; in-range ids are left as they are).
    lookups = [[(table, ids.to(torch.int64).clamp(0, table.shape[0] - 1))
                for table, ids in s] for s in sets]
    return dict(
        name="row_gather", tol="bit-exact", max_abs_err=err, ok=err == 0.0,
        source="multiverso_tpu_torch/csrc/row_gather.cu",
        replaces="multiverso_tpu/tables/matrix_table.py:2761",
        ms=time_ms(torch, in_turn(
            sets, lambda t, ids: rows.row_gather(t, ids, D))),
        plain_ms=time_ms(torch, in_turn(
            sets, lambda t, ids: rows.row_gather_plain(t, ids, D))),
        library_ms=time_ms(torch, in_turn(
            lookups, lambda t, ids: t.index_select(0, ids))),
        bound=bound(n_bytes))


def on_grid(torch, table, ids, delta):
    """``table`` and ``delta`` rounded to the grid 2^-k with k chosen so
    that every partial sum of scatter-adding ``delta`` into ``table`` is
    a multiple of 2^-k below 2^(24-k) in magnitude, hence exact in
    float32: the sum is then the same in any order, and K3 (float
    atomics) and its plain version must agree bit for bit."""
    uniq, inv = torch.unique(ids.reshape(-1)[:delta.shape[0]],
                             return_inverse=True)
    mass = torch.zeros(uniq.numel(), delta.shape[1], dtype=torch.float64,
                       device=delta.device)
    mass.index_add_(0, inv, delta.abs().double())
    top = float(table.abs().max()) + float(mass.max())
    # 3 bits of margin for the rounding of the terms themselves.
    k = 21 - math.ceil(math.log2(max(top, 2.0 ** -60)))
    grid = 2.0 ** k
    return torch.round(table * grid) / grid, torch.round(delta * grid) / grid


def check_scatter(torch, cases, D: int, row_bytes: int = 0, rotate=()):
    """K3 on ``cases``, the step's (table, ids, delta) triples, each
    rounded ``on_grid``: bit-exact on every triple, duplicate ids and
    the Zipf head included; timed over all of them, as the step launches
    them (``rotate``: as in ``check_gather``). The bound counts the ids
    and rows of the delta, and each table row they reach read and
    written at ``row_bytes`` (default ``D * 4``; 32 for rows narrower
    than a sector)."""
    from multiverso_tpu_torch.kernels import rows
    err, nonzero, n_bytes = 0.0, [], 0
    for table, ids, delta in cases:
        base, grid_delta = on_grid(torch, table, ids, delta)
        nonzero.append(float((grid_delta != 0).float().mean()))
        a = base.clone()
        rows.row_scatter_add(a, ids, grid_delta, 1.0)
        rows.row_scatter_add_plain(base, ids, grid_delta, 1.0)
        err = max(err, float((a - base).abs().max()))
        del a, base
        k = delta.shape[0]
        reached = touched_rows(torch, ids.reshape(-1)[:k], table.shape[0])
        n_bytes += k * 4 + k * D * 4 + 2 * reached * (row_bytes or D * 4)
    clones = {}
    sets = [[(clones.setdefault(id(table), table.clone()), ids,
              ids.reshape(-1)[:delta.shape[0]].to(torch.int64), delta)
             for table, ids, delta in s] for s in [cases, *rotate]]
    result = dict(
        name="row_scatter_add",
        tol=f"bit-exact on grid-rounded deltas ({[round(x, 3) for x in nonzero]}"
            f" of them nonzero)", max_abs_err=err, ok=err == 0.0,
        source="multiverso_tpu_torch/csrc/row_scatter_add.cu",
        replaces="multiverso_tpu/updater/rules.py:94",
        ms=time_ms(torch, in_turn(
            sets, lambda t, ids, _, d: rows.row_scatter_add(t, ids, d, 1.0))),
        plain_ms=time_ms(torch, in_turn(
            sets, lambda t, ids, _, d: rows.row_scatter_add_plain(
                t, ids, d, 1.0))),
        library_ms=time_ms(torch, in_turn(
            sets, lambda t, _, ids64, d: t.narrow(1, 0, d.shape[1])
            .index_add_(0, ids64, d))),
        bound=bound(n_bytes))
    del sets, clones
    return result


def report(results, card: str, path: str):
    """Log the checks of ``path``'s kernels; fail on any disagreement."""
    for r in results:
        r["path"] = path
        lib = "n/a" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        log(f"[kernel {r['name']} @ {path}] {card} | max_abs_err "
            f"{r['max_abs_err']:g} ({r['tol']}) "
            f"{'OK' if r['ok'] else 'FAIL'} | kernel {r['ms']:.4f} ms | "
            f"plain {r['plain_ms']:.4f} ms | library {lib} | bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{path}: kernels disagree with their plain "
                             f"versions: {bad}")
    return results


def check_wide_blocks(torch, device) -> None:
    """K4 and K5 with a negative block wider than a thread block (B=512
    centers share their negatives; ``-neg_block`` is a user flag) at a
    small width, against their plain versions: every center's window
    count must be formed, not only the first 256."""
    from multiverso_tpu_torch.kernels import cbow, sgns
    C, W, K, B, D = 2048, 5, 5, 512, 16
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    pmask = (torch.rand(C, 2 * W, generator=gen, device=device)
             < 0.8).float()
    band = torch.randn(C + 2 * W, D, generator=gen, device=device)
    v = torch.randn(C, D, generator=gen, device=device)
    negs = torch.randn(C // B * K, D, generator=gen, device=device)
    cases = (("banded_sgns_grad", sgns.banded_sgns_grad,
              sgns.banded_sgns_grad_plain, (v, torch.cat([band, negs]))),
             ("banded_cbow_grad", cbow.banded_cbow_grad,
              cbow.banded_cbow_grad_plain, (band, torch.cat([v, negs]))))
    for name, kernel, plain, rows_in in cases:
        got = kernel(*rows_in, pmask, W, K, B, -0.025)
        ref = plain(*rows_in, pmask, W, K, B, -0.025)
        ok = all(bool(((g - r).abs() <= 1e-5 + 1e-4 * r.abs()).all())
                 for g, r in zip(got[:2], ref[:2]))
        ok = ok and float(got[3]) == float(ref[3]) and abs(
            float(got[2]) - float(ref[2])) <= 1e-5 * abs(float(ref[2]))
        log(f"[kernel {name}] neg_block {B} > 256 threads, C={C} D={D}: "
            f"{'OK' if ok else 'FAIL'} (grads |err| <= 1e-5 + 1e-4 "
            f"|plain|, loss rel err <= 1e-5, counts equal)")
        if not ok:
            raise AssertionError(f"{name} disagrees at neg_block {B}")


def check_kernels(torch, trainer, card: str):
    """Phase 3: every kernel of the PS path against its plain version,
    timed."""
    from multiverso_tpu_torch.kernels import rows, sgns
    dev = trainer.device
    C, B = trainer._C, trainer._B
    W, K = trainer.config.window, trainer.config.negative
    D = trainer.config.embedding_size
    u, in_ids, out_ids, pmask = block0_inputs(torch, trainer)
    results = [check_subsample(torch, trainer._corpus, u)]

    # Tables for K2-K4: random rows (the model's output table is still
    # zero), the main path's heights and width.
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    table_in = torch.randn(trainer.model._in_table.num_row, D,
                           generator=gen, device=dev) * 0.5
    table_out = torch.randn(trainer.model._out_table.num_row, D,
                            generator=gen, device=dev) * 0.5
    results.append(check_gather(torch, ((table_in, in_ids),
                                        (table_out, out_ids)), D))
    # K3 with random deltas of the push's size.
    results.append(check_scatter(torch, (
        (table_in, in_ids, torch.randn(in_ids.numel(), D, generator=gen,
                                       device=dev) * 1e-2),
        (table_out, out_ids, torch.randn(out_ids.numel(), D, generator=gen,
                                         device=dev) * 1e-2)), D))

    # K4 banded_sgns_grad on the block's pulled rows (random tables, so
    # some logits pass +-6).
    v = rows.row_gather(table_in, in_ids, D)
    urows = rows.row_gather(table_out, out_ids, D)
    scale = -0.025
    got = sgns.banded_sgns_grad(v, urows, pmask, W, K, B, scale)
    ref = sgns.banded_sgns_grad_plain(v, urows, pmask, W, K, B, scale)
    err = 0.0
    ok = True
    for g, r in zip(got[:2], ref[:2]):    # the push deltas d_v, d_u
        diff = (g - r).abs()
        err = max(err, float(diff.max()))
        ok = ok and bool((diff <= 1e-5 + 1e-4 * r.abs()).all())
    loss_rel = abs(float(got[2]) - float(ref[2])) / abs(float(ref[2]))
    ok = ok and loss_rel <= 1e-5 and float(got[3]) == float(ref[3])
    nb = C // B
    flops = 2 * D * (C * 2 * W + C * K) * 2 + 2 * D * C * 2 * W \
        + 2 * D * nb * K * B
    results.append(dict(
        name="banded_sgns_grad",
        tol=f"deltas |err| <= 1e-5 + 1e-4 |plain|; loss rel err "
            f"{loss_rel:.2g} <= 1e-5; pairs equal",
        max_abs_err=err, ok=ok,
        source="multiverso_tpu_torch/csrc/banded_sgns.cu",
        replaces="multiverso_tpu/models/wordembedding/device_train.py:729",
        ms=time_ms(torch, lambda: sgns.banded_sgns_grad(
            v, urows, pmask, W, K, B, scale)),
        plain_ms=time_ms(torch, lambda: sgns.banded_sgns_grad_plain(
            v, urows, pmask, W, K, B, scale)),
        library_ms=None,
        bound=bound((C * D + urows.numel() + C * 2 * W) * 4
                    + (C * D + urows.numel()) * 4 + 8, flops)))
    del table_in, table_out
    check_wide_blocks(torch, dev)
    return report(results, card, "ps")


def timed_blocks(trainer, seed: int, blocks: int):
    """One epoch of ``blocks`` blocks: (block losses as device scalars,
    per-block host ms, wall seconds, Python GC pauses as (generation,
    ms), loss sum, pairs, raw words)."""
    import gc
    model = trainer.model
    pauses = []
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           (time.perf_counter() - started["t"]) * 1e3))

    losses, marks = [], []
    words0 = model.trained_words
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        loss_sum, pairs = trainer.train_epoch(
            seed=seed, max_steps=blocks,
            block_hook=lambda _w: (losses.append(trainer.last_loss),
                                   marks.append(time.perf_counter())))
        elapsed = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    block_ms = [round((b - a) * 1e3, 2)
                for a, b in zip([t0] + marks[:-1], marks)]
    return (losses, block_ms, elapsed, pauses, loss_sum, pairs,
            model.trained_words - words0)


def drive_main_path(torch, trainer, blocks: int):
    """Phase 4: the main path with the launch counts reset just before
    and read just after."""
    from multiverso_tpu_torch import kernels
    from multiverso_tpu_torch.util.dashboard import Dashboard
    trainer.train_epoch(seed=99, max_steps=2)  # warm-up, not counted
    Dashboard.reset()
    kernels.reset_launch_counts()
    run = timed_blocks(trainer, 0, blocks)
    counts = kernels.launch_counts()
    return counts, run, Dashboard.display()


def report_run(tag: str, card: str, centers: int, run) -> None:
    losses, block_ms, elapsed, pauses, loss_sum, pairs, words = run
    log(f"[{tag}] {card} | {len(losses)} blocks of {centers} centers in "
        f"{elapsed:.3f}s | {words / elapsed:.0f} words/s | "
        f"{elapsed / max(len(losses), 1) * 1e3:.2f} ms/block | pairs "
        f"{pairs:.0f} | avg pair loss {loss_sum / max(pairs, 1):.4f}")
    log(f"[{tag}] host ms per block {block_ms} | Python GC pauses "
        f"(generation, ms) {[(g, round(ms, 1)) for g, ms in pauses]}")


def trace_kernels(prof, trace: str):
    """(kernel count, busy ms — the union of the kernels' spans, summed
    kernel ms) of a finished ``torch.profiler`` run, read from its Chrome
    trace written to ``trace``."""
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("cat") == "kernel" and "dur" in e)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(spans), busy / 1e3, sum(b - a for a, b in spans) / 1e3


def profile_main_path(torch, trainer, outdir: str, card: str,
                      blocks: int) -> None:
    """Optional (``--profile DIR``): the main path under torch.profiler
    and the dashboard's host monitors — where a block's time goes."""
    import torch.profiler as tp
    from multiverso_tpu_torch.util.dashboard import Dashboard
    os.makedirs(outdir, exist_ok=True)
    Dashboard.reset()
    marks = []
    activities = [tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]
    with tp.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(seed=7, max_steps=blocks,
                            block_hook=lambda _w: marks.append(
                                time.perf_counter()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_kernels, busy_ms, _ = trace_kernels(
        prof, os.path.join(outdir, "ps_blocks_trace.json"))
    gaps = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    log(f"[profile] {card} | {blocks} blocks in {wall * 1e3:.1f} ms wall "
        f"| {n_kernels} kernels, device busy {busy_ms:.2f} ms "
        f"({busy_ms / (wall * 1e3):.1%} of wall) | per-block host ms "
        f"{[round(g * 1e3, 2) for g in gaps]}")
    for line in Dashboard.display().splitlines():
        log(f"[profile] {line}")
    table = prof.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=30)
    for line in table.splitlines():
        log(f"[profile] {line}")


def check_result(np, model, losses, pairs):
    """Phase 5a: finite losses and rows of the expected shapes."""
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite block losses: {losses}")
    if pairs <= 0:
        raise AssertionError("no training pairs")
    sample = np.arange(0, model._in_table.num_row, 997, dtype=np.int32)
    for table in (model._in_table, model._out_table):
        rows = table.get_rows(sample)
        if rows.shape != (sample.size, table.num_col) \
                or not np.isfinite(rows).all():
            raise AssertionError(f"table {table.table_id}: bad rows")
    if not np.abs(model._out_table.get_rows(sample)).max() > 0:
        raise AssertionError("output table never updated")


def write_topics(workdir: str) -> str:
    """The tests' topic corpus (two topics of 8 words, 800 sentences of
    12 words) in ``workdir``; returns its path."""
    import numpy as np
    path = os.path.join(workdir, "topics.txt")
    rng = np.random.default_rng(0)
    topics = [[f"a{i}" for i in range(8)], [f"b{i}" for i in range(8)]]
    with open(path, "w") as f:
        for _ in range(800):
            f.write(" ".join(rng.choice(topics[rng.integers(0, 2)],
                                        size=12)) + "\n")
    return path


def small_run(torch, mv, device, workdir: str, flags=None, G: int = 1):
    """Phase 5b and 7 helper: the tests' topic corpus, 6 blocks of 128
    centers (``flags`` added to the PS SGNS config, G blocks a
    dispatch), draws from one CPU generator; returns (losses a dispatch,
    examples, in rows, out rows)."""
    import numpy as np
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
        TorchDraws, Word2VecConfig)
    path = write_topics(workdir)
    dictionary = Dictionary.build(path, min_count=1)
    tokenized = TokenizedCorpus.build(dictionary, path)
    mv.init([], device=str(device))
    try:
        config = Word2VecConfig(**{**dict(
            embedding_size=16, window=3, negative=5, epochs=2, min_count=1,
            sample=1e-2, use_ps=True, neg_block=8), **(flags or {})})
        model = PSWord2Vec(config, dictionary)
        trainer = PSDeviceCorpusTrainer(
            model, tokenized, centers_per_step=128, blocks_per_dispatch=G,
            draws=TorchDraws(device, draw_device="cpu"))
        losses = []
        _, examples = trainer.train_epoch(
            seed=5, max_steps=6, block_hook=lambda _w: losses.append(
                float(trainer.last_loss)))
        return (np.array(losses), examples, model._in_table.get(),
                model._out_table.get())
    finally:
        mv.shutdown()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def step_kernel_case(torch, trainer, table_in, table_out):
    """The mode's step-kernel call at step (block) 0 of an epoch, as
    either trainer plans it (the per-pair mode: the sub-step of offset
    -1, the densest of the 2W), with rows from the random tables
    ``table_in``/``table_out``; its plain version; and the bytes and
    float32 operations the call needs for this data (masked Huffman
    nodes and invalid pairs are not read): (kernel, plain, args, bytes,
    flops, ids) with ``ids`` = (the epoch's uniforms, in_ids,
    out_ids)."""
    from multiverso_tpu_torch.kernels import cbow, hs, objective, pair
    from multiverso_tpu_torch.kernels import rows, sgns
    C, W, K = trainer._C, trainer.config.window, trainer.config.negative
    D = trainer.config.embedding_size
    u = trainer._draws.epoch_uniforms(1234, trainer._corpus.n_tokens)
    subs, pmask = step0_plan(trainer, u)
    in_ids, out_ids, kernel, extra = subs[W - 1 if trainer._per_pair
                                          else 0]
    ids = (u, in_ids, out_ids)
    a = rows.row_gather(table_in, in_ids, D)
    b = rows.row_gather(table_out, out_ids, D)
    args = (a, b) + tuple(extra)
    outputs = nbytes(a, b)       # every gradient row written once
    if kernel is pair.pair_offset_grad:
        m = extra[0]
        n_pairs = int((m > 0).sum())
        return (kernel, pair.pair_offset_grad_plain, args,
                n_pairs * (K + 2) * D * 4 + nbytes(m) + outputs + 8,
                6 * D * (K + 1) * n_pairs, ids)
    if kernel in (hs.banded_hs_sg_grad, hs.hs_cbow_grad):
        path, code = extra[0], extra[1]
        ok = (path >= 0) & (code >= 0)
        log(f"[kernel {kernel.__name__}] Huffman paths of up to "
            f"L={path.shape[1]} nodes; {float((path < 0).float().mean()):.1%}"
            f" of step 0's path ids are padding")
        if kernel is hs.hs_cbow_grad:
            n_nodes = int((ok & (pmask.sum(1) > 0)[:, None]).sum())
            return (kernel, hs.hs_cbow_grad_plain, args,
                    nbytes(a, path, code, pmask) + n_nodes * D * 4
                    + outputs + 8, 2 * D * C * 2 * W * 2 + 6 * D * n_nodes,
                    ids)
        reached = objective.band_sum(
            pmask, torch.ones(C, device=pmask.device), W) > 0
        n_rows = int((ok & reached[:, None]).sum())
        n_terms = int(sum((pmask[:, j, None] * ok[W + o:W + o + C]).sum()
                          for j, o in enumerate(objective.offsets(W))))
        return (kernel, hs.banded_hs_sg_grad_plain, args,
                nbytes(a, path, code, pmask) + n_rows * D * 4 + outputs
                + 8, 6 * D * n_terms, ids)
    if kernel is cbow.banded_cbow_grad:
        return (kernel, cbow.banded_cbow_grad_plain, args,
                2 * nbytes(a, b) + nbytes(pmask) + 8,
                2 * D * C * 2 * W * 2 + 2 * D * C * (1 + K) * 3 + D * C,
                ids)
    nb = C // trainer._B
    return (kernel, sgns.banded_sgns_grad_plain, args,
            2 * nbytes(a, b) + nbytes(pmask) + 8,
            2 * D * (C * 2 * W + C * K) * 2 + 2 * D * C * 2 * W
            + 2 * D * nb * K * trainer._B, ids)


def random_tables(torch, device, shapes):
    """Random float32 tables of ``shapes`` (seeded; rows of scale 0.5,
    so some logits pass +-6)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(99)
    return [torch.randn(shape, generator=gen, device=device) * 0.5
            for shape in shapes]


def compare_step(got, ref):
    """(max abs error of the two gradients, ok, loss relative error):
    gradients |err| <= 1e-5 + 1e-4 |plain|, loss relative error <= 1e-5,
    counts equal."""
    err, ok = 0.0, True
    for g, r in zip(got[:2], ref[:2]):
        diff = (g - r).abs()
        err = max(err, float(diff.max()))
        ok = ok and bool((diff <= 1e-5 + 1e-4 * r.abs()).all())
    loss_rel = abs(float(got[2]) - float(ref[2])) / max(abs(float(ref[2])),
                                                       1e-30)
    ok = ok and loss_rel <= 1e-5 and float(got[3]) == float(ref[3])
    return err, ok, loss_rel


def ps_group_case(torch, trainer, u, table_in, table_out, first: int = 0):
    """What a PS trainer's first dispatch pulls and pushes (the first
    group of G blocks of an epoch whose uniforms are ``u``, as
    ``train_epoch`` forms it; with ``first``, the group of G blocks from
    block ``first``), over the random tables: the G blocks' pull
    ids joined (per-pair: each block's band and all its 2W*C*K
    negatives) and the push deltas of each block's step on its slice of
    the pulled rows: ((table_in, in_ids, d_in), (table_out, out_ids,
    d_out)), the server's K2 and K3 work for the dispatch."""
    from multiverso_tpu_torch.kernels import rows
    from multiverso_tpu_torch.models.wordembedding import device_train
    C, G, W = trainer._C, trainer._G, trainer.config.window
    D = trainer.config.embedding_size
    kept, ksent, n_kept = trainer._corpus.prep_epoch(u)
    kept_pad, ksent_pad = device_train._pad_stream(C, W, kept, ksent)
    n_kept = int(n_kept)
    draws = device_train.TorchDraws(trainer.device).group_draws(
        1234, first, G, C, W, trainer._neg_shape(), trainer._vocab)
    blocks = [device_train._block_ids(
        trainer.config, trainer._tables, C, trainer._B, trainer._per_pair,
        draws[i], kept_pad, ksent_pad, n_kept, (first + i) * C, 0.025, 1.0)
        for i in range(min(G, max(math.ceil(n_kept / C) - first, 1)))]
    in_ids = device_train._cat([b[0] for b in blocks])
    out_ids = device_train._cat([b[1] for b in blocks])
    v = rows.row_gather(table_in, in_ids, D)
    u_rows = rows.row_gather(table_out, out_ids, D)
    n_in, n_out = blocks[0][0].numel(), blocks[0][1].numel()
    d_in, d_out = [], []
    for i, (_, _, step) in enumerate(blocks):
        dv, du, _, _ = step(v[i * n_in:(i + 1) * n_in],
                            u_rows[i * n_out:(i + 1) * n_out])
        d_in.append(dv)
        d_out.append(du)
    log(f"[ps_group_case] G={len(blocks)} blocks: pulls and pushes of "
        f"{in_ids.numel()} input and {out_ids.numel()} output rows")
    return ((table_in, in_ids, device_train._cat(d_in)),
            (table_out, out_ids, device_train._cat(d_out)))


def check_step_kernels(torch, trainer, path: str, name: str, source: str,
                       replaces: str, card: str, shapes, ps: bool = False):
    """Every kernel of a device-pipeline path against its plain version
    on the card over random tables of ``shapes`` (the model's two),
    timed: K1 on the epoch's uniforms; the step kernel
    (``compare_step``) at step (block) 0's call; K2 and K3 at the step's
    ids into both tables, K3 scattering the step kernel's gradients —
    with ``ps``, at what the first dispatch pulls and pushes
    (``ps_group_case``: all G blocks' ids, the per-pair mode's
    negatives included)."""
    D = trainer.config.embedding_size
    table_in, table_out = random_tables(torch, trainer.device, shapes)
    kernel, plain, args, n_bytes, flops, (u, in_ids, out_ids) = \
        step_kernel_case(torch, trainer, table_in, table_out)
    got = kernel(*args)
    if ps:
        scatters = ps_group_case(torch, trainer, u, table_in, table_out)
    else:
        scatters = ((table_in, in_ids, got[0]), (table_out, out_ids, got[1]))
    results = [check_subsample(torch, trainer._corpus, u),
               check_gather(torch, tuple(c[:2] for c in scatters), D)]
    ref = plain(*args)
    err, ok, loss_rel = compare_step(got, ref)
    results.append(dict(
        name=name, tol=f"grads |err| <= 1e-5 + 1e-4 |plain|; loss rel err "
        f"{loss_rel:.2g} <= 1e-5; counts equal", max_abs_err=err, ok=ok,
        source=source, replaces=replaces,
        ms=time_ms(torch, lambda: kernel(*args)),
        plain_ms=time_ms(torch, lambda: plain(*args)), library_ms=None,
        bound=bound(n_bytes, flops)))
    log(f"[kernel {name} @ {path}] C={trainer._C} | bound from "
        f"{n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP")
    results.append(check_scatter(torch, scatters, D))
    del table_in, table_out, got, ref, args, scatters
    return report(results, card, path)


def check_tables(np, model, path: str, step: int = 997) -> None:
    """Every ``step``-th row of both tables finite, and the output table
    updated — local tensors or PS tables."""
    rows = []
    for i in (0, 1):
        if hasattr(model, "_in_table"):
            table = (model._in_table, model._out_table)[i]
            rows.append(table.get_rows(
                np.arange(0, table.num_row, step, dtype=np.int32)))
        else:
            rows.append((model._emb_in, model._emb_out)[i][::step]
                        .cpu().numpy())
    if not all(np.isfinite(r).all() for r in rows):
        raise AssertionError(f"{path}: non-finite table rows")
    if not np.abs(rows[1]).max() > 0:
        raise AssertionError(f"{path}: output table never updated")


def drive_counted(torch, model, path: str, need, card: str, workdir: str,
                  profile_dir: str, run, steps: int, unit: str):
    """A path's main run: ``run()`` (-> (loss, examples)) with every
    launch count reset just before and read just after, words/s on the
    host clock; then the same run under torch.profiler (device ms a
    ``unit`` of kernels, the card's busy share; the Chrome trace kept in
    ``profile_dir`` when given). Every kernel of ``need`` must have
    launched; the host monitors of the counted run (the PS paths' pull
    stall, step, push and server times) are logged. Returns the
    counts."""
    from multiverso_tpu_torch import kernels
    from multiverso_tpu_torch.util.dashboard import Dashboard
    cuda = torch.cuda.is_available() and model_device(model).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    Dashboard.reset()
    kernels.reset_launch_counts()
    words0 = model.trained_words
    t0 = time.perf_counter()
    loss, examples = run()
    sync()
    elapsed = time.perf_counter() - t0
    counts = kernels.launch_counts()
    words = model.trained_words - words0
    log(f"[{path}] {card} | {steps} x {unit} in {elapsed:.4f}s | "
        f"{words / elapsed:.0f} words/s | {elapsed / steps * 1e3:.3f} ms a "
        f"{unit} | examples {examples:.0f} | avg loss "
        f"{loss / max(examples, 1):.4f}")
    log(f"[{path}] kernel launches {counts}")
    for line in Dashboard.display().splitlines():
        log(f"[{path}] {line}")
    if not (math.isfinite(loss) and examples > 0):
        raise AssertionError(f"{path}: loss {loss}, examples {examples}")
    missing = [n for n in need if counts[n] <= 0] if cuda else []
    if missing:
        raise AssertionError(f"{path} never launched {missing}")
    if cuda:
        import torch.profiler as tp
        with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            wall = time.perf_counter() - t0
        trace = os.path.join(profile_dir or workdir, f"{path}_trace.json")
        n_kernels, busy_ms, kernel_ms = trace_kernels(prof, trace)
        log(f"[{path}] profiled: {n_kernels} kernels, device "
            f"{kernel_ms / steps:.4f} ms a {unit} of kernels, busy "
            f"{busy_ms:.2f} ms of {wall * 1e3:.2f} ms wall "
            f"({busy_ms / (wall * 1e3):.1%})")
    return counts


def model_shapes(model):
    """The shapes of the model's two tables (local or PS)."""
    if hasattr(model, "_in_table"):
        return tuple((t.num_row, t.num_col)
                     for t in (model._in_table, model._out_table))
    return (tuple(model._emb_in.shape), tuple(model._emb_out.shape))


def model_device(model):
    return model._in_table.zoo.device if hasattr(model, "_in_table") \
        else model.device


def compare_small(np, tag: str, got, ref) -> None:
    """Card vs CPU on the small input: (loss, examples, in rows, out
    rows), examples equal, the rest at rtol 1e-4 / atol 1e-6."""
    if got[1] != ref[1]:
        raise AssertionError(f"small input {tag}: examples {got[1]} vs "
                             f"{ref[1]}")
    for name, g, r in zip(("loss", "in rows", "out rows"),
                          (got[0], got[2], got[3]),
                          (ref[0], ref[2], ref[3])):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{tag} {name}")
    log(f"[small input] {tag}: card vs CPU plain path: loss "
        f"{float(np.sum(got[0])):.6f} vs {float(np.sum(ref[0])):.6f}, "
        f"examples {got[1]:.0f}, both tables agree (rtol 1e-4, atol 1e-6)")


def small_local_run(torch, device, workdir: str, flags: dict):
    """The topic corpus of the tests, C=128, G=4, 6 steps, draws from one
    CPU generator: (epoch loss, examples, input rows, output rows)."""
    import numpy as np
    from multiverso_tpu_torch.models.wordembedding import (
        DeviceCorpusTrainer, Dictionary, TokenizedCorpus, TorchDraws,
        Word2Vec, Word2VecConfig)
    path = write_topics(workdir)
    dictionary = Dictionary.build(path, min_count=1)
    tokenized = TokenizedCorpus.build(dictionary, path)
    config = Word2VecConfig(**{**dict(
        embedding_size=16, window=3, negative=5, epochs=2, min_count=1,
        sample=1e-2), **flags})
    model = Word2Vec(config, dictionary, device=device)
    same_init(torch, model)
    trainer = DeviceCorpusTrainer(model, tokenized, centers_per_step=128,
                                  steps_per_dispatch=4,
                                  draws=TorchDraws(device,
                                                   draw_device="cpu"))
    loss, examples = trainer.train_epoch(seed=5, max_steps=6)
    return (loss, examples, model._emb_in.cpu().numpy(),
            model._emb_out.cpu().numpy())


def same_init(torch, model) -> None:
    """The same initial input rows on both devices (the card's generator
    draws other numbers than the CPU's)."""
    import numpy as np
    dim = model._emb_in.shape[1]
    init = np.random.default_rng(1).uniform(
        -0.5 / dim, 0.5 / dim, tuple(model._emb_in.shape)).astype(np.float32)
    model._emb_in.copy_(torch.from_numpy(init))


def run_local_phase(torch, np, device, dictionary, tokenized, card: str,
                    workdir: str, profile_dir: str, dim: int,
                    scale_down: int):
    """Phase 6: every local mode at the bench's settings (``scale_down``
    divides the step size in the CPU rehearsal). Returns (kernel
    results, launch counts per path ``local_<mode>``)."""
    from multiverso_tpu_torch.models.wordembedding import (
        DeviceCorpusTrainer, Word2Vec, Word2VecConfig)
    results, counts = [], {}
    for mode, flags, C, G, kernel, source, replaces in LOCAL_MODES:
        path = f"local_{mode}"
        t0 = time.perf_counter()
        config = Word2VecConfig(**{**dict(
            embedding_size=dim, window=WINDOW, negative=NEG, epochs=3,
            min_count=1, sample=1e-3), **flags})
        model = Word2Vec(config, dictionary, device=device)
        trainer = DeviceCorpusTrainer(model, tokenized, C // scale_down, G)
        log(f"[{path}] model + trainer {time.perf_counter() - t0:.1f}s"
            f" | tables {tuple(model._emb_in.shape)} in, "
            f"{tuple(model._emb_out.shape)} out | C={trainer._C} G={G}")
        shapes = model_shapes(model)
        if device.type == "cuda":
            results += check_step_kernels(torch, trainer, path, kernel,
                                          source, replaces, card, shapes)
        else:   # the rehearsal: the case's shapes and byte counts only
            step_kernel_case(torch, trainer,
                             *random_tables(torch, device, shapes))
        trainer.train_epoch(seed=99, max_steps=2)    # warm-up, not counted
        counts[path] = drive_counted(
            torch, model, path, ("subsample_compact", "row_gather",
                                 "row_scatter_add", kernel),
            card, workdir, profile_dir,
            lambda: trainer.train_epoch(seed=0, max_steps=2 * G), 2 * G,
            "step")
        check_tables(np, model, path)
        del model, trainer
        free(torch, device)
    for mode, flags, *_ in LOCAL_MODES:
        compare_small(np, f"local {mode}, 6 steps",
                      small_local_run(torch, device, workdir, flags),
                      small_local_run(torch, torch.device("cpu"), workdir,
                                      flags))
    return results, counts


def free(torch, device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_ps_modes_phase(torch, np, mv, device, dictionary, tokenized,
                       card: str, workdir: str, profile_dir: str, dim: int,
                       scale_down: int):
    """Phase 7: the PS device pipeline's other configurations (CBOW, HS
    skip-gram, HS CBOW, per-pair at G=4, SGNS at G=8) at the bench's
    settings, each under its own ``mv.init``: every kernel of the path
    against its plain version (``check_step_kernels`` with ``ps``), a
    counted run of max(2G, 8) blocks, finite tables, and the topic
    corpus trained on the card and on the CPU with the same draws.
    Returns (kernel results, launch counts per path)."""
    from multiverso_tpu_torch.models.wordembedding import (
        PSDeviceCorpusTrainer, PSWord2Vec, Word2VecConfig)
    results, counts = [], {}
    for path, flags, C, G, kernel, source, replaces in PS_MODES:
        t0 = time.perf_counter()
        mv.init([], device=None if device.type == "cuda" else "cpu")
        try:
            config = Word2VecConfig(**{**dict(
                embedding_size=dim, window=WINDOW, negative=NEG, epochs=3,
                min_count=1, sample=1e-3, use_ps=True), **flags})
            model = PSWord2Vec(config, dictionary)
            trainer = PSDeviceCorpusTrainer(model, tokenized,
                                            C // scale_down, G)
            shapes = model_shapes(model)
            log(f"[{path}] model + trainer {time.perf_counter() - t0:.1f}s "
                f"| tables {shapes} | C={trainer._C} G={G}")
            if device.type == "cuda":
                results += check_step_kernels(torch, trainer, path, kernel,
                                              source, replaces, card,
                                              shapes, ps=True)
            else:   # the rehearsal: the cases' shapes and byte counts
                tables = random_tables(torch, device, shapes)
                step_kernel_case(torch, trainer, *tables)
                ps_group_case(torch, trainer, trainer._draws.epoch_uniforms(
                    1234, trainer._corpus.n_tokens), *tables)
                del tables
            trainer.train_epoch(seed=99, max_steps=G)   # warm-up
            blocks = max(2 * G, 8)
            counts[path] = drive_counted(
                torch, model, path, ("subsample_compact", "row_gather",
                                     "row_scatter_add", kernel),
                card, workdir, profile_dir,
                lambda: trainer.train_epoch(seed=0, max_steps=blocks),
                blocks, "block")
            check_tables(np, model, path)
        finally:
            mv.shutdown()
        del model, trainer
        free(torch, device)
    for path, flags, _, G, *_ in PS_MODES:
        compare_small(np, f"{path}, 6 blocks, G={G}",
                      small_run(torch, mv, device, workdir, flags, G),
                      small_run(torch, mv, torch.device("cpu"), workdir,
                                flags, G))
    return results, counts


class CpuBatchDraws:
    """Host-batch negative draws from a CPU generator seeded per batch:
    the same numbers for a run on the card and one on the CPU."""

    def batch_draws(self, counter, shape, V):
        import torch
        gen = torch.Generator()
        gen.manual_seed(1000 + counter)
        return (torch.randint(0, V, shape, generator=gen,
                              dtype=torch.int32),
                torch.rand(shape, generator=gen))


def hb_batches(dictionary, tokenized, batch_size: int, window: int,
               cbow: bool, n: int, sample: float = 1e-3):
    """The first ``n`` batches of an epoch (seed 0) as the app ships
    them (``iter_pair_batches``)."""
    from multiverso_tpu_torch.models.wordembedding import iter_pair_batches
    out = []
    for batch in iter_pair_batches(dictionary, tokenized,
                                   batch_size=batch_size, window=window,
                                   subsample=sample, cbow=cbow, seed=0):
        out.append(batch)
        if len(out) == n:
            break
    return out


def hb_kernel_case(torch, model, batch, tables, ps: bool):
    """The host-batch step kernel's call on ``batch`` as the path forms
    it over the random ``tables`` — local: the whole tables and global
    ids; PS: the rows pulled (K2) at the CompactBatch's padded row sets,
    and its slot maps — with its plain version, the flat rows K3 adds
    the gradients into, the pull ids (PS) and the bytes and float32
    operations the call needs for this data (rows named by live pairs
    and unmasked nodes read once, every gradient row written once)."""
    from multiverso_tpu_torch.kernels import pairlist, rows
    D = tables[0].shape[1]
    dev = tables[0].device
    pulls = None
    if ps:
        t0 = time.perf_counter()
        compact = model.prepare(batch)
        log(f"[hb_kernel_case] host preparation of one batch (prepare, "
            f"numpy): {(time.perf_counter() - t0) * 1e3:.1f} ms; padded row "
            f"sets {compact.rows_in_p.size} in, {compact.rows_out_p.size} "
            f"out ({compact.rows_in.size}, {compact.rows_out.size} real)")
        in_ids, win_mask, out_args, pm = model._compact_args(compact, dev)
        pulls = tuple(torch.from_numpy(a).to(dev)
                      for a in (compact.rows_in_p, compact.rows_out_p))
        bufs = tuple(rows.row_gather(t, ids, D)
                     for t, ids in zip(tables, pulls))
    else:
        in_ids, win_mask, out_args, pm = model._batch_args(batch)
        bufs = tables
    hs = bool(model.config.hs)
    kernel = pairlist.pairlist_hs_grad if hs else pairlist.pairlist_ns_grad
    plain = pairlist.pairlist_hs_grad_plain if hs \
        else pairlist.pairlist_ns_grad_plain
    args = (bufs[0], bufs[1], in_ids, win_mask, *out_args, pm, -0.025)
    live = pm > 0
    in_named = in_ids[live] if win_mask is None \
        else in_ids[live[:, None] & (win_mask > 0)]
    if hs:
        node = live[:, None] & (out_args[1] >= 0)
        out_rows = out_args[0].reshape(-1)
        out_named = out_args[0][node]
        n_terms = int(node.sum())
    else:
        negs = out_args[1]
        out_rows = torch.cat([out_args[0], negs.reshape(-1)])
        block_live = live.reshape(negs.shape[0], -1).any(dim=1)
        out_named = torch.cat([out_args[0][live],
                               negs[block_live].reshape(-1)])
        n_terms = int(live.sum()) * (1 + negs.shape[1])
    n_read = int(torch.unique(in_named).numel()
                 + torch.unique(out_named).numel())
    written = in_ids.numel() + out_rows.numel()
    ids = [in_ids, pm, *out_args] + ([] if win_mask is None else [win_mask])
    n_bytes = (n_read + written) * D * 4 + nbytes(*ids) + 8
    flops = 6 * D * n_terms + 2 * D * int(in_named.numel())
    return (kernel, plain, args, bufs, in_ids.reshape(-1), out_rows, pulls,
            n_bytes, flops)


def check_hb_kernels(torch, model, batch, path: str, name: str,
                     source: str, replaces: str, card: str, ps: bool):
    """The host-batch path's kernels against their plain versions at the
    first batch's real ids over random tables of the model's shapes,
    timed: K2 at the pulls (PS), K9 or K10, and K3 scattering its
    gradients (local: into the tables; PS: into zeroed delta buffers of
    the pulled shape, and those buffers into the tables at the padded
    row sets, as the server applies the push)."""
    from multiverso_tpu_torch.kernels import rows
    D = model.config.embedding_size
    tables = random_tables(torch, model_device(model), model_shapes(model))
    (kernel, plain, args, bufs, in_rows, out_rows, pulls, n_bytes,
     flops) = hb_kernel_case(torch, model, batch, tables, ps)
    results = []
    if ps:
        results.append(check_gather(torch, tuple(zip(tables, pulls)), D))
    got = kernel(*args)
    ref = plain(*args)
    err, ok, loss_rel = compare_step(got, ref)
    results.append(dict(
        name=name, tol=f"grads |err| <= 1e-5 + 1e-4 |plain|; loss rel err "
        f"{loss_rel:.2g} <= 1e-5; counts equal", max_abs_err=err, ok=ok,
        source=source, replaces=replaces,
        ms=time_ms(torch, lambda: kernel(*args)),
        plain_ms=time_ms(torch, lambda: plain(*args)), library_ms=None,
        bound=bound(n_bytes, flops)))
    log(f"[kernel {name} @ {path}] B={args[4].shape[0]} | buffers "
        f"{tuple(bufs[0].shape)} in, {tuple(bufs[1].shape)} out | bound "
        f"from {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP")
    scatters = ((bufs[0], in_rows, got[0]), (bufs[1], out_rows, got[1]))
    if ps:
        # The client's adds into zeroed delta buffers of the pulled
        # shape, then the server's adds of those buffers at the padded
        # row sets into the tables.
        scatters = tuple((torch.zeros_like(b), ids, g)
                         for b, ids, g in scatters)
        deltas = []
        for zeros, ids, g in scatters:
            delta = zeros.clone()
            rows.row_scatter_add(delta, ids, g)
            deltas.append(delta)
        scatters += tuple(zip(tables, pulls, deltas))
        del deltas
    results.append(check_scatter(torch, scatters, D))
    del tables, got, ref, args, bufs, scatters
    return report(results, card, path)


def small_hb_run(torch, mv, device, workdir: str, flags: dict, ps: bool):
    """The topic corpus, 8 batches of 128, negatives from
    a CPU generator (local) or numpy (PS): (loss, pairs, input rows,
    output rows)."""
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, PSWord2Vec, TokenizedCorpus, Word2Vec, Word2VecConfig)
    path = write_topics(workdir)
    dictionary = Dictionary.build(path, min_count=1)
    tokenized = TokenizedCorpus.build(dictionary, path)
    config = Word2VecConfig(**{**dict(
        embedding_size=16, window=3, negative=5, epochs=2, min_count=1,
        sample=1e-2, batch_size=128, use_ps=ps,
        neg_block=4 if ps else 1), **flags})
    batches = hb_batches(dictionary, tokenized, 128, 3, config.cbow, 8,
                         1e-2)
    if ps:
        mv.init([], device=str(device))
        try:
            model = PSWord2Vec(config, dictionary)
            loss, pairs = model.train_batches(iter(batches))
            return (loss, pairs, model._in_table.get(),
                    model._out_table.get())
        finally:
            mv.shutdown()
    model = Word2Vec(config, dictionary, device=device,
                     draws=CpuBatchDraws())
    same_init(torch, model)
    loss, pairs = model.train_batches(iter(batches))
    return (loss, pairs, model._emb_in.cpu().numpy(),
            model._emb_out.cpu().numpy())


def run_hostbatch_phase(torch, np, mv, device, dictionary, tokenized,
                        card: str, workdir: str, profile_dir: str,
                        dim: int, scale_down: int):
    """Phase 8: the host-batch trainer (``-device_pipeline=false``) in
    all four modes, locally (batches of 32768, launched one by one) and
    through the parameter server (batches of 131072, neg_block 8, the
    pipelined loop behind a ``BlockLoader``): every kernel of the path
    against its plain version at the first batch's ids, a warm-up of 2
    batches, a counted run (16 batches locally, 4 through the PS),
    finite tables, and the topic corpus trained on the card and on the
    CPU with the same draws. Returns (kernel results, launch counts per
    path ``hb_local_<mode>``/``hb_ps_<mode>``)."""
    from multiverso_tpu_torch.models.wordembedding import (
        BlockLoader, PSWord2Vec, Word2Vec, Word2VecConfig)
    results, counts = [], {}
    for mode, flags, kernel, source in HB_MODES:
        for ps in (False, True):
            size, nb, n = HB_PS if ps else HB_LOCAL
            size //= scale_down
            path = f"hb_{'ps' if ps else 'local'}_{mode}"
            t0 = time.perf_counter()
            batches = hb_batches(dictionary, tokenized, size, WINDOW,
                                 bool(flags.get("cbow")), n + 2)
            t1 = time.perf_counter()
            config = Word2VecConfig(**{**dict(
                embedding_size=dim, window=WINDOW, negative=NEG, epochs=3,
                min_count=1, sample=1e-3, batch_size=size,
                neg_block=nb, use_ps=ps), **flags})
            if ps:
                mv.init([], device=None if device.type == "cuda" else "cpu")
            try:
                model = PSWord2Vec(config, dictionary) if ps \
                    else Word2Vec(config, dictionary, device=device)
                log(f"[{path}] {len(batches)} batches of {size} in "
                    f"{t1 - t0:.1f}s, model {time.perf_counter() - t1:.1f}s")
                replaces = _MODEL_REF + ("755" if ps else "395")
                if device.type == "cuda":
                    results += check_hb_kernels(torch, model, batches[0],
                                                path, kernel, source,
                                                replaces, card, ps)
                else:   # the rehearsal: the case's shapes and bytes
                    hb_kernel_case(torch, model, batches[0], random_tables(
                        torch, device, model_shapes(model)), ps)
                model.train_batches(iter(batches[:2]))     # warm-up
                counted = batches[2:]
                need = (("row_gather",) if ps else ()) + (
                    kernel, "row_scatter_add")
                run = (lambda: model.train_batches(BlockLoader(
                    model.prepared(iter(counted))))) if ps else \
                    (lambda: model.train_batches(iter(counted)))
                counts[path] = drive_counted(
                    torch, model, path, need, card, workdir, profile_dir,
                    run, len(counted), "batch")
                check_tables(np, model, path)
            finally:
                if ps:
                    mv.shutdown()
            del model, batches
            free(torch, device)
    for mode, flags, *_ in HB_MODES:
        for ps in (False, True):
            compare_small(np, f"hb_{'ps' if ps else 'local'}_{mode}, 8 "
                          f"batches", small_hb_run(torch, mv, device,
                                                   workdir, flags, ps),
                          small_hb_run(torch, mv, torch.device("cpu"),
                                       workdir, flags, ps))
    return results, counts


# -- phase 9: the logistic-regression app --

# The LIBSVM "criteo" set's widths (LIBSVM data sets, binary class,
# criteo: 1,000,000 hashed features, 39 nonzeros a sample from 13
# numeric and 26 categorical fields, binary labels).
LR_FEATURES, LR_NUMERIC, LR_CATEGORICAL = 1_000_000, 13, 26
LR_BATCH, LR_WARM, LR_COUNTED = 4096, 4, 64
LR_CLI_SAMPLES = 50_000
_LR_REF = "multiverso_tpu/models/logreg/"
_LR_SRC = _CSRC + "sparse_logreg.cu"
# (path, config, model family): the reference's defaults otherwise
# (models/logreg/config.py), FTRL's alpha 0.005, beta 1, lambda1 5,
# lambda2 0.002 among them.
_LR_SGD = dict(objective_type="sigmoid", regular_type="L2",
               regular_coef=0.0005, updater_type="sgd", learning_rate=0.8)
LR_SPARSE_PATHS = (
    ("lr_sparse_local", _LR_SGD, "local"),
    ("lr_ftrl_local", dict(objective_type="sigmoid", updater_type="ftrl"),
     "ftrl"),
    ("lr_sparse_ps", dict(_LR_SGD, use_ps=True, pipeline=True,
                          sync_frequency=1), "ps"),
    ("lr_ftrl_ps", dict(objective_type="sigmoid", updater_type="ftrl",
                        use_ps=True, sync_frequency=1), "ftrl"),
)
# The reference example's mnist.config widths: 784 inputs, 10 classes,
# softmax, minibatch 20.
LR_DENSE = dict(input_size=784, output_size=10, objective_type="softmax",
                regular_type="L2", updater_type="sgd", use_ps=True,
                minibatch_size=20, sync_frequency=1)


def criteo_like(np, n: int, seed: int):
    """``n`` samples at criteo's widths: keys [n, 39] int64 (the 13
    numeric fields on keys 0-12, then the 26 categorical fields, each a
    Zipf(1.1) draw from its own slice of the hashed space, scattered by
    a fixed permutation, so a sample's keys are distinct), values [n,
    39] float32 (numeric: 0.3 log1p of a count >= 1, a scale at which
    the reference's default learning rate 0.8 is stable; categorical:
    1) and labels int32 drawn from a planted weight vector and bias
    (29% positive, near criteo's quarter), so that the loss falls in
    every model of phase 9."""
    rng = np.random.default_rng(seed)
    span = (LR_FEATURES - LR_NUMERIC) // LR_CATEGORICAL
    cdf = np.cumsum(np.arange(1, span + 1, dtype=np.float64) ** -1.1)
    cdf /= cdf[-1]
    perm = rng.permutation(LR_FEATURES - LR_NUMERIC) + LR_NUMERIC
    ranks = np.searchsorted(cdf, rng.random((n, LR_CATEGORICAL)))
    cat = perm[np.minimum(ranks, span - 1)
               + np.arange(LR_CATEGORICAL) * span]
    keys = np.concatenate([np.broadcast_to(np.arange(LR_NUMERIC),
                                           (n, LR_NUMERIC)), cat], axis=1)
    values = np.concatenate([
        0.3 * np.log1p(rng.geometric(0.05, (n, LR_NUMERIC))),
        np.ones((n, LR_CATEGORICAL))], axis=1).astype(np.float32)
    planted = rng.standard_normal(LR_FEATURES) * 0.5
    planted[:LR_NUMERIC] *= 0.2
    score = (values * planted[keys]).sum(axis=1) - 1.5
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-score))).astype(np.int32)
    return keys.astype(np.int64), values, labels


def lr_batches(np, keys, values, labels, batch: int):
    """Full batches as the reader packs them (``reader._pack``): keys
    padded to ``bucket_size(39)`` with the padding key ``input_size``,
    values 0 there, every weight 1."""
    from multiverso_tpu_torch.models.logreg import Batch
    from multiverso_tpu_torch.updater.engine import bucket_size
    width = bucket_size(keys.shape[1])
    out = []
    for lo in range(0, keys.shape[0] - batch + 1, batch):
        k = np.full((batch, width), LR_FEATURES, np.int64)
        v = np.zeros((batch, width), np.float32)
        k[:, :keys.shape[1]] = keys[lo:lo + batch]
        v[:, :keys.shape[1]] = values[lo:lo + batch]
        out.append(Batch(labels[lo:lo + batch].copy(),
                         np.ones(batch, np.float32), keys=k, values=v,
                         count=batch))
    return out


def lr_config(extra: dict, input_size: int = LR_FEATURES,
              batch: int = LR_BATCH):
    from multiverso_tpu_torch.models.logreg import Configure
    return Configure(**dict(dict(input_size=input_size, output_size=1,
                                 sparse=True, minibatch_size=batch),
                            **extra))


def lr_grid(torch, values, diff, keys, rows: int, count: float):
    """``values`` and ``diff`` rounded to grids on which every partial sum
    K12 forms — ``values * diff / count`` summed per touched row — is
    exact in float32 (``count`` a power of two): values to 2^-2, diff to
    the finest 2^-q that keeps each row's mass below 2^(24 - 2 - q) times
    its quantum, with 3 bits of margin. K12 and its plain version then
    agree bit for bit whatever order they sum in."""
    from multiverso_tpu_torch.kernels import logreg as lrk
    vg = torch.round(values * 4) / 4
    t = lrk.touched_rows(keys, rows)
    pos = t.occ.to(torch.int64)
    seg = torch.repeat_interleave(torch.arange(t.rows.numel(),
                                               device=keys.device),
                                  t.counts)
    mass = torch.zeros(t.rows.numel(), dtype=torch.float64,
                       device=keys.device)
    mass.index_add_(0, seg, (vg.reshape(-1)[pos].abs().double()
                             * diff.abs().amax(1).double()[
                                 pos // values.shape[1]]) / count)
    top = max(float(mass.max()), 2.0 ** -60)
    lq = math.log2(count)
    q = int(math.floor(24 - 2 - lq - 3 - math.log2(top) - 1))
    q = max(min(q, 20), 0)
    return vg, torch.round(diff * 2.0 ** q) / 2.0 ** q


def lr_tables(torch, R: int, C: int, ftrl, gen, device):
    """Random state of the main path's height: ``w`` or FTRL's ``(z, n)``
    (|z| beyond lambda1 often enough that weights are nonzero)."""
    if ftrl is None:
        return torch.randn(R, C, generator=gen, device=device) * 0.1
    z = torch.randn(R, C, generator=gen, device=device) * 2 * max(
        ftrl.lambda1, 1.0)
    n = torch.rand(R, C, generator=gen, device=device) * 4
    return z, n


def _clone_table(table):
    return table.clone() if not isinstance(table, tuple) \
        else tuple(t.clone() for t in table)


def lr_case(torch, np, tag: str, config, batch, gen, device, ps: bool,
            dup: bool = False, time_it: bool = True):
    """K11 and K12 against their plain versions at ``batch``'s shapes on
    random state of ``config``'s model (``ps``: K12 also returns the
    push — the delta rows, or FTRL's dense push buffers): K11 within
    |err| <= 1e-5 + 1e-4 |plain| (pred, diff), loss sum rel err <= 1e-5
    and equal hit counts; K12 bit-exact on values and diffs rounded by
    ``lr_grid``. ``dup`` repeats keys within samples (a quarter of the
    samples name their first categorical key twice more). Returns the
    two kernels' result entries (timed when ``time_it``)."""
    from multiverso_tpu_torch.kernels import logreg as lrk
    from multiverso_tpu_torch.models.logreg import objective
    R, C = config.input_size + 1, max(config.output_size, 1)
    ftrl = objective.ftrl_params(config) \
        if config.updater_type == "ftrl" else None
    act = objective._act_code(config.objective_type)
    reg = objective._reg_code(config.regular_type)
    keys_np = batch.keys.astype(np.int32)
    if dup:
        keys_np[::4, LR_NUMERIC + 1] = keys_np[::4, LR_NUMERIC]
        keys_np[::4, LR_NUMERIC + 2] = keys_np[::4, LR_NUMERIC]
    keys = torch.from_numpy(keys_np).to(device)
    values = torch.from_numpy(batch.values).to(device)
    labels = torch.from_numpy(batch.labels).to(device)
    if C > 1:
        labels = torch.randint(0, C, labels.shape, generator=gen,
                               device=device, dtype=torch.int32)
    weights = torch.from_numpy(batch.weights).to(device)
    table = lr_tables(torch, R, C, ftrl, gen, device)
    B, K = keys.shape

    got = lrk.sparse_lr_forward(table, keys, values, labels, weights, act,
                                ftrl)
    ref = lrk.sparse_lr_forward_plain(table, keys, values, labels, weights,
                                      act, ftrl)
    err, ok = 0.0, True
    for g, r in zip(got[:2], ref[:2]):
        d = (g - r).abs()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= 1e-5 + 1e-4 * r.abs()).all())
    loss_rel = abs(float(got[2].sum()) - float(ref[2].sum())) / max(
        abs(float(ref[2].sum())), 1e-30)
    hits = (int(got[3].sum()), int(ref[3].sum()))
    ok = ok and loss_rel <= 1e-5 and hits[0] == hits[1]
    sectors = -(-C * 4 // 32) * 32     # bytes of a table row's sectors
    tables = 1 if ftrl is None else 2
    gathered = int(torch.unique(lrk.gather_ids(keys, R)).numel())
    fwd_bytes = B * K * 4 * 2 + B * 4 * 2 + gathered * sectors * tables \
        + B * C * 4 * 2 + B * 4 * 2
    fwd = dict(
        name="sparse_lr_forward", ok=ok, max_abs_err=err,
        tol=f"pred, diff |err| <= 1e-5 + 1e-4 |plain|; loss rel err "
            f"{loss_rel:.2g} <= 1e-5; hits {hits[0]} = {hits[1]}",
        source=_LR_SRC, replaces=_LR_REF + "objective.py:89",
        library_ms=None, bound=bound(fwd_bytes, 2.0 * B * K * C))

    count = torch.full((1,), float(max(int((weights > 0).sum()), 1)),
                       device=device)
    vg, dg = lr_grid(torch, values, ref[1], keys, R, float(count))
    scale = 0.8

    def push_buffers():
        if not (ps and ftrl is not None):
            return None
        return (torch.zeros(R, C, device=device),
                torch.zeros(R, C, device=device))

    a, b = _clone_table(table), _clone_table(table)
    pa, pb = push_buffers(), push_buffers()
    want_rows = ps and ftrl is None
    rows_a, delta_a = lrk.sparse_lr_apply(
        a, keys, vg, dg, count, reg=reg, coef=config.regular_coef,
        scale=scale, ftrl=ftrl, delta_rows=want_rows, push=pa)
    touched = lrk.touched_rows(keys, R)
    delta_b = lrk.sparse_lr_apply_plain(
        b, touched, vg, dg, count, reg, config.regular_coef, scale, ftrl,
        want_rows, pb)
    pairs = list(zip((a,) if ftrl is None else a, (b,) if ftrl is None
                     else b))
    if want_rows:
        pairs.append((delta_a, delta_b))
    if pa is not None:
        pairs += list(zip(pa, pb))
    apply_err = max(float((x - y).abs().max()) for x, y in pairs)
    same_rows = bool(torch.equal(rows_a, touched.rows))
    U = int(touched.rows.numel())
    app_bytes = B * K * 4 * 2 + B * C * 4 + 4 + U * sectors * 2 * tables \
        + (U * C * 4 if want_rows else 0) \
        + (U * sectors * 2 if pa is not None else 0)
    app = dict(
        name="sparse_lr_apply", ok=apply_err == 0.0 and same_rows,
        max_abs_err=apply_err,
        tol=f"bit-exact on grid-rounded values and diffs ({U} touched "
            f"rows, the padding row's {int(touched.counts[-1])} "
            f"positions among them)",
        source=_LR_SRC, replaces=_LR_REF + "objective.py:89",
        library_ms=None, bound=bound(app_bytes, 3.0 * B * K * C))
    log(f"[{tag}] K11/K12 case: B={B} K={K} C={C} R={R} "
        f"{'ftrl' if ftrl else 'sgd'} act={act} reg={reg} dup={dup} | "
        f"{gathered} gathered rows, {U} touched | K11 "
        f"{'OK' if fwd['ok'] else 'FAIL'} ({fwd['tol']}) | K12 "
        f"{'OK' if app['ok'] else 'FAIL'} (max err {apply_err:g})")
    if time_it:
        ta, pa2 = _clone_table(table), push_buffers()
        fwd["ms"] = time_ms(torch, lambda: lrk.sparse_lr_forward(
            table, keys, values, labels, weights, act, ftrl))
        fwd["plain_ms"] = time_ms(torch, lambda: lrk.sparse_lr_forward_plain(
            table, keys, values, labels, weights, act, ftrl))

        def run_kernel():
            return lrk.sparse_lr_apply(
                ta, keys, vg, dg, count, reg=reg, coef=config.regular_coef,
                scale=scale, ftrl=ftrl, delta_rows=want_rows, push=pa2)

        def run_plain():
            return lrk.sparse_lr_apply_plain(
                ta, lrk.touched_rows(keys, R), vg, dg, count, reg,
                config.regular_coef, scale, ftrl, want_rows, pa2)

        app["ms"] = time_ms(torch, run_kernel)
        app["kernel_only_ms"] = time_ms(torch, run_kernel,
                                        only="sparse_lr_apply_kernel")
        app["plain_ms"] = time_ms(torch, run_plain)
        log(f"[{tag}] K12 {app['ms']:.4f} ms a call, of which the kernel "
            f"{app['kernel_only_ms']:.4f} ms (the rest: the ids' sort, "
            f"unique and task split in torch)")
    return [fwd, app]


def lr_ps_table_checks(torch, np, model, batch, device):
    """K2 and K3 where ``lr_sparse_ps`` runs them on the server: K2 at
    the first pull (every row) and at a later pull (no row dirty: the
    bucket of sentinel ids), K3 at the push of one batch's touched rows
    (the sgd rule's scatter), each on a random table of the server's
    shape."""
    from multiverso_tpu_torch.kernels import logreg as lrk
    from multiverso_tpu_torch.updater.engine import pad_ids
    server = model._table.zoo.server_tables[model._table.table_id]
    R = server._data.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(41)
    table = torch.randn(tuple(server._data.shape), generator=gen,
                        device=device)
    every = torch.from_numpy(pad_ids(np.arange(R, dtype=np.int32), R)).to(
        device)
    none = torch.from_numpy(pad_ids(np.zeros(0, np.int32), R)).to(device)
    keys = torch.from_numpy(batch.keys.astype(np.int32)).to(device)
    rows = lrk.touched_rows(keys, R).rows
    rows = rows[rows < model.config.input_size].to(torch.int32).cpu()
    ids = torch.from_numpy(pad_ids(rows.numpy(), R)).to(device)
    delta = torch.randn(rows.numel(), 1, generator=gen, device=device) \
        * 1e-2
    return [check_gather(torch, ((table, every), (table, none)), 1),
            check_scatter(torch, ((table, ids, delta),), 1, row_bytes=32)]


def lr_model(mv, family: str, config, device):
    from multiverso_tpu_torch.models.logreg import (FTRLModel, LocalModel,
                                                    PSModel)
    dev = None if device.type == "cuda" else "cpu"
    if config.use_ps:
        mv.init([], device=dev)
        return PSModel(config) if family == "ps" \
            else FTRLModel(config, use_ps=True)
    if family == "ftrl":
        return FTRLModel(config, device=device)
    return LocalModel(config, device=device)


def drive_lr(torch, model, path: str, need, card: str, workdir: str,
             profile_dir: str, batches, warm: int):
    """``warm`` batches, then the rest counted: launch counts reset just
    before and read just after, samples/s on the host clock (synced);
    then the same batches under torch.profiler (device ms a batch of
    kernels, the card's busy share). Every kernel of ``need`` must have
    launched; every loss must be finite. Returns the counts."""
    from multiverso_tpu_torch import kernels
    from multiverso_tpu_torch.util.dashboard import Dashboard
    cuda = model.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for b in batches[:warm]:
        model.update(b)
    counted = batches[warm:]
    sync()
    Dashboard.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [model.update(b) for b in counted]
    sync()
    elapsed = time.perf_counter() - t0
    counts = kernels.launch_counts()
    samples = sum(b.count for b in counted)
    log(f"[{path}] {card} | {len(counted)} batches of {counted[0].count} "
        f"in {elapsed:.4f}s | {samples / elapsed:.0f} samples/s | "
        f"{elapsed / len(counted) * 1e3:.3f} ms a batch | avg loss first "
        f"{losses[0] / counted[0].count:.5f} last "
        f"{losses[-1] / counted[-1].count:.5f}")
    log(f"[{path}] kernel launches { {k: v for k, v in counts.items() if v} }")
    for line in Dashboard.display().splitlines():
        log(f"[{path}] {line}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{path}: non-finite losses {losses}")
    missing = [n for n in need if counts[n] <= 0] if cuda else []
    if missing:
        raise AssertionError(f"{path} never launched {missing}")
    if cuda:
        import torch.profiler as tp
        with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in counted:
                model.update(b)
            sync()
            wall = time.perf_counter() - t0
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(profile_dir or workdir, f"{path}_trace.json")
        n_kernels, busy_ms, kernel_ms = trace_kernels(prof, trace)
        log(f"[{path}] profiled: {n_kernels} kernels, device "
            f"{kernel_ms / len(counted):.4f} ms a batch of kernels, busy "
            f"{busy_ms:.2f} ms of {wall * 1e3:.2f} ms wall "
            f"({busy_ms / (wall * 1e3):.1%})")
    return counts


def write_lr_sparse(np, path: str, n: int = 96, d: int = 40, seed: int = 0):
    """The tests' libsvm set (tests/test_logreg.py ``write_sparse_data``)."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(d)
    lines = []
    for _ in range(n):
        nnz = rng.integers(3, 8)
        keys = np.sort(rng.choice(d, nnz, replace=False))
        vals = rng.standard_normal(nnz)
        label = int(w_true[keys] @ vals > 0)
        lines.append(f"{label} " + " ".join(
            f"{k}:{v:.5f}" for k, v in zip(keys, vals)))
    with open(path, "w") as f:
        f.write("\n".join(lines))


def write_lr_dense(np, path: str, n: int = 100, d: int = 8,
                   classes: int = 3, seed: int = 0):
    """The tests' dense set (tests/test_logreg.py ``write_dense_data``)."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(42).standard_normal((classes, d)) * 3
    lines = []
    for _ in range(n):
        label = rng.integers(0, classes)
        x = centers[label] + rng.standard_normal(d) * 0.3
        lines.append(str(label) + " " + " ".join(f"{v:.5f}" for v in x))
    with open(path, "w") as f:
        f.write("\n".join(lines))


LR_SMALL = (
    ("local sparse", "local", dict(_LR_SGD, learning_rate=0.5)),
    ("local dense", "local", dict(objective_type="softmax",
                                  updater_type="sgd", regular_type="L2",
                                  learning_rate=0.5, sparse=False,
                                  input_size=8, output_size=3,
                                  minibatch_size=20)),
    ("ftrl local", "ftrl", dict(objective_type="sigmoid",
                                updater_type="ftrl", alpha=0.1,
                                lambda1=0.01, lambda2=0.01)),
    ("ps sparse", "ps", dict(_LR_SGD, learning_rate=0.5, use_ps=True)),
    ("ps dense", "ps", dict(objective_type="softmax", updater_type="sgd",
                            learning_rate=0.5, sparse=False, input_size=8,
                            output_size=3, minibatch_size=20, use_ps=True,
                            sync_frequency=2)),
    ("ftrl ps", "ftrl", dict(objective_type="sigmoid", updater_type="ftrl",
                             alpha=0.1, lambda1=0.01, lambda2=0.01,
                             use_ps=True, sync_frequency=2)),
)


def small_lr_run(torch, np, mv, device, workdir: str, family: str,
                 extra: dict):
    """The tests' small set, 2 epochs from zero weights: (losses a batch,
    correct counts a batch, final weights)."""
    from multiverso_tpu_torch.models.logreg import (iter_samples,
                                                    make_batches)
    dense = extra.get("sparse") is False
    path = os.path.join(workdir, "lr_small_dense.txt" if dense
                        else "lr_small_sparse.txt")
    (write_lr_dense if dense else write_lr_sparse)(np, path)
    config = lr_config(extra, input_size=40, batch=16)
    batches = list(make_batches(config, iter_samples(config, path))) * 2
    model = lr_model(mv, family, config, device)
    try:
        losses = [model.update(b) for b in batches]
        correct = []
        for b in batches:
            pred = model.predict(b)[:b.count]
            guess = (pred[:, 0] >= 0.5).astype(np.int32) \
                if pred.shape[1] == 1 else pred.argmax(1).astype(np.int32)
            correct.append(int((guess == b.labels[:b.count]).sum()))
        return np.asarray(losses), correct, np.asarray(model.weights)
    finally:
        if config.use_ps:
            mv.shutdown()


def lr_cli(np, device, workdir: str, samples: int) -> None:
    """``python -m multiverso_tpu_torch.models.logreg.main <config>``:
    train + test on a synthetic libsvm file of ``samples`` criteo-like
    samples (the CPU rehearsal calls ``main`` in this process)."""
    keys, values, labels = criteo_like(np, samples, seed=77)
    data = os.path.join(workdir, "lr_cli.libsvm")
    t0 = time.perf_counter()
    with open(data, "w") as f:
        for k, v, y in zip(keys, values, labels):
            f.write(f"{y} " + " ".join(f"{a}:{b:.6g}" for a, b in zip(k, v))
                    + "\n")
    config = os.path.join(workdir, "lr_cli.config")
    model_file = os.path.join(workdir, "lr_cli.model")
    out_file = os.path.join(workdir, "lr_cli.out")
    with open(config, "w") as f:
        f.write(f"input_size={LR_FEATURES}\noutput_size=1\nsparse=true\n"
                f"objective_type=sigmoid\nregular_type=L2\n"
                f"updater_type=sgd\nminibatch_size={LR_BATCH}\n"
                f"train_epoch=1\nshow_time_per_sample=20000\n"
                f"train_file={data}\ntest_file={data}\n"
                f"output_model_file={model_file}\noutput_file={out_file}\n")
    t1 = time.perf_counter()
    if device.type == "cuda":
        here = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.run(
            [sys.executable, "-m", "multiverso_tpu_torch.models.logreg.main",
             config], cwd=here, capture_output=True, text=True, timeout=600)
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-6:]
        for line in tail:
            log(f"[lr_cli]   {line}")
        if proc.returncode != 0:
            raise AssertionError(f"logreg CLI exited {proc.returncode}")
    else:
        from multiverso_tpu_torch.models.logreg.main import main as lr_main
        if lr_main([config], device="cpu") != 0:
            raise AssertionError("logreg CLI failed")
    size = os.path.getsize(model_file)
    with open(out_file) as f:
        lines = sum(1 for _ in f)
    if size != (LR_FEATURES + 1) * 4 or lines != samples:
        raise AssertionError(f"logreg CLI wrote a {size}-byte model and "
                             f"{lines} prediction lines")
    log(f"[lr_cli] {samples} samples written in {t1 - t0:.1f}s; train + "
        f"test in {time.perf_counter() - t1:.1f}s (rc 0): model "
        f"{size} bytes, {lines} prediction lines")


def run_logreg_phase(torch, np, mv, device, card: str, workdir: str,
                     profile_dir: str, rehearsal: bool):
    """Phase 9: the logistic-regression app on a seeded criteo-like
    corpus. Returns (kernel results, launch counts per ``lr_*`` path)."""
    batch = LR_BATCH // 64 if rehearsal else LR_BATCH
    warm, counted = (2, 4) if rehearsal else (LR_WARM, LR_COUNTED)
    t0 = time.perf_counter()
    keys, values, labels = criteo_like(np, (warm + counted) * batch, seed=9)
    batches = lr_batches(np, keys, values, labels, batch)
    del keys, values, labels
    log(f"[lr] {len(batches)} batches of {batch} criteo-like samples "
        f"({LR_FEATURES} features, 39 a sample, padded to "
        f"{batches[0].keys.shape[1]}) in {time.perf_counter() - t0:.1f}s")
    results, counts = [], {}
    cuda = device.type == "cuda"
    if cuda:
        # The extra cases: softmax at C=10, L1, duplicate keys in a
        # sample, FTRL with L1 — at the first batch's shapes.
        gen = torch.Generator(device=device)
        gen.manual_seed(5)
        extra = (dict(_LR_SGD, objective_type="softmax", output_size=10),
                 dict(_LR_SGD, regular_type="L1"),
                 dict(objective_type="sigmoid", updater_type="ftrl",
                      regular_type="L1", regular_coef=0.001))
        for i, cfg in enumerate(extra):
            entries = lr_case(torch, np, f"lr extra {i}", lr_config(cfg),
                              batches[0], gen, device, ps=i == 2, dup=True,
                              time_it=False)
            bad = [e["name"] for e in entries if not e["ok"]]
            if bad:
                raise AssertionError(f"lr extra case {i}: {bad} disagree")
    for path, cfg, family in LR_SPARSE_PATHS:
        config = lr_config(cfg, batch=batch)
        model = lr_model(mv, family, config, device)
        try:
            need = ["sparse_lr_forward", "sparse_lr_apply"]
            if cuda:
                gen = torch.Generator(device=device)
                gen.manual_seed(17)
                entries = lr_case(torch, np, path, config, batches[0], gen,
                                  device, ps=config.use_ps)
                if family == "ps":
                    entries += lr_ps_table_checks(torch, np, model,
                                                  batches[0], device)
                    need += ["row_gather", "row_scatter_add"]
                results += report(entries, card, path)
            counts[path] = drive_lr(torch, model, path, need, card, workdir,
                                    profile_dir, batches, warm)
            if not np.isfinite(model.weights).all():
                raise AssertionError(f"{path}: non-finite weights")
        finally:
            if config.use_ps:
                mv.shutdown()
        del model
        free(torch, device)
    # lr_dense_ps: the mnist.config widths, torch only; the array table
    # lives on the card.
    from multiverso_tpu_torch.models.logreg import Batch, Configure, PSModel
    rng = np.random.default_rng(3)
    centers = rng.random((10, 784)).astype(np.float32)
    dense = []
    for _ in range(warm + counted):
        y = rng.integers(0, 10, 20).astype(np.int32)
        x = np.clip(centers[y] + rng.standard_normal((20, 784)) * 0.2, 0, 1)
        dense.append(Batch(y, np.ones(20, np.float32),
                           x=x.astype(np.float32), count=20))
    mv.init([], device=None if cuda else "cpu")
    try:
        model = PSModel(Configure(**LR_DENSE))
        server = model._table.zoo.server_tables[model._table.table_id]
        if server._data.device != device:
            raise AssertionError(f"the array table lies on "
                                 f"{server._data.device}")
        counts["lr_dense_ps"] = drive_lr(torch, model, "lr_dense_ps", (),
                                         card, workdir, profile_dir, dense,
                                         warm)
    finally:
        mv.shutdown()
    del batches, dense
    free(torch, device)
    for tag, family, extra in LR_SMALL:
        got = small_lr_run(torch, np, mv, device, workdir, family, extra)
        ref = small_lr_run(torch, np, mv, torch.device("cpu"), workdir,
                           family, extra)
        if got[1] != ref[1]:
            raise AssertionError(f"small input lr {tag}: correct counts "
                                 f"{got[1]} vs {ref[1]}")
        for name, g, r in (("losses", got[0], ref[0]),
                           ("weights", got[2], ref[2])):
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6,
                                       err_msg=f"lr {tag} {name}")
        log(f"[small input] lr {tag}: card vs CPU plain path: losses "
            f"{float(got[0].sum()):.6f} vs {float(ref[0].sum()):.6f}, "
            f"correct {sum(got[1])} = {sum(ref[1])}, weights agree (rtol "
            f"1e-4, atol 1e-6)")
    lr_cli(np, device, workdir, 2000 if rehearsal else LR_CLI_SAMPLES)
    return results, counts


# -- phase 10: the table data plane --

# bench.py matrix_bandwidth (:3587-3700), the reference's port of the
# upstream test_matrix_perf.cpp: 1,000,000 x 50 float32 tables, every 10th
# row dirty (100,000 a round, ids bucket-padded to 131,072), 10 rounds.
TBL_ROWS, TBL_COLS, TBL_EVERY = 1_000_000, 50, 10
TBL_WARM, TBL_ITERS = 2, 10
TBL_HYP = dict(momentum=0.9, learning_rate=0.01, rho=0.1, lambda_=0.1)
# (path suffix, updater_type, the reference's rows program)
TBL_RULES = (("momentum", "momentum_sgd", "multiverso_tpu/updater/rules.py:120"),
             ("adagrad", "adagrad", "multiverso_tpu/updater/rules.py:144"),
             ("dcasgd", "dcasgd", "multiverso_tpu/updater/rules.py:184"))
# Float operations a rule takes an element and occurrence (rules.py).
TBL_FLOPS = {"default": 1, "momentum": 4, "adagrad": 8, "dcasgd": 9}
TBL_TOL = dict(rtol=1e-5, atol=1e-7)
# Sets of ids and deltas timed in turn: 4 others (~45-100 MB each) pass
# between two calls on one set, more than the card's 50 MB L2.
TBL_ROTATE = 5
# The id sets K13 and K14 are checked on (``tbl_kernel_checks``).
TBL_CASES = ("bench ids", "5% duplicates", "edge ids", "one row 4,096 times",
             "a worker past the slots")


def tbl_state(torch, rule: str, table, gen):
    """A seeded state of ``rule`` for ``table`` [R, S]: momentum's
    smoothed deltas, AdaGrad's squared gradients (>= 0), DCASGD's backup
    near the table; one worker slot, as the zoo has one worker."""
    noise = torch.randn(table.shape, generator=gen, device=table.device)
    if rule == "momentum":
        return noise * 0.01
    if rule == "adagrad":
        return (noise.abs() * 0.01)[None].contiguous()
    return (table + noise * 0.01)[None].contiguous()


def tbl_rows_bytes(n: int, k: int, uniq: int, C: int, state: bool) -> int:
    """Bytes a row update must move: the ids, the delta, each touched row
    read and written, and its state row read and written."""
    return n * 4 + k * C * 4 + uniq * C * 4 * (4 if state else 2)


def tbl_check_rule(torch, rules, rule: str, replaces: str, table, state,
                   cases, sets, hyp, C: int):
    """K13 against its plain version on each (ids, delta, worker) of
    ``cases`` (data and state within TBL_TOL), then timed on the
    (ids, delta) ``sets`` in turn, worker 0."""
    err, failed = 0.0, []
    for name, (ids, delta, worker) in zip(TBL_CASES, cases):
        a_d, a_s = table.clone(), state.clone()
        rules.row_rule_apply(rule, a_d, a_s, ids, delta, hyp, worker)
        dev = tbl_plain_device(torch, name, table)
        b_d, b_s = table.to(dev, copy=True), state.to(dev, copy=True)
        rules.row_rule_apply_plain(rule, b_d, b_s, ids.to(dev),
                                   delta.to(dev), hyp, worker)
        a_d, a_s = a_d.to(dev), a_s.to(dev)
        case_err = max(float((a_d - b_d).abs().max()),
                       float((a_s - b_s).abs().max()))
        err = max(err, case_err)
        if not (torch.allclose(a_d, b_d, **TBL_TOL)
                and torch.allclose(a_s, b_s, **TBL_TOL)):
            failed.append(f"{name} ({case_err:g})")
        del a_d, a_s, b_d, b_s
    ids, delta = sets[0]
    uniq = touched_rows(torch, ids, table.shape[0])
    a_d, a_s = table.clone(), state.clone()
    result = dict(
        name="row_rule_apply", tol="rtol 1e-5 / atol 1e-7 (data, state) "
        f"on {', '.join(TBL_CASES[:len(cases)])}"
        + (f"; FAILED on {failed}" if failed else ""),
        max_abs_err=err, ok=not failed,
        source="multiverso_tpu_torch/csrc/row_rules.cu", replaces=replaces,
        ms=time_ms(torch, in_turn([[s] for s in sets], lambda i, d: rules.
                                  row_rule_apply(rule, a_d, a_s, i, d, hyp,
                                                 0))),
        plain_ms=time_ms(torch, in_turn(
            [[s] for s in sets], lambda i, d: rules.row_rule_apply_plain(
                rule, a_d, a_s, i, d, hyp, 0))),
        library_ms=None,
        bound=bound(tbl_rows_bytes(ids.numel(), delta.shape[0], uniq, C,
                                   True),
                    TBL_FLOPS[rule] * touched_ids(torch, ids, table) * C))
    del a_d, a_s
    return result


def tbl_plain_device(torch, name: str, table):
    """Where a case's plain version runs: on the CPU for the row at 4,096
    positions, whose steps of both signs cancel in the sum — K13 and K14
    add a run's steps in position order, as ``index_add_`` does on the
    CPU, while on the card its float atomics take another order each
    run, by more than rtol 1e-5 of such a sum; on the card otherwise."""
    return torch.device("cpu") if name == TBL_CASES[3] else table.device


def touched_ids(torch, ids, table) -> int:
    """Occurrences of ``ids`` that reach a row of ``table``."""
    flat = ids.to(torch.int64)
    R = table.shape[0]
    return int(((flat >= -R) & (flat < R)).sum())


def tbl_check_fused(torch, rules, rule: str, table, state, cases, sets,
                    hyp, C: int):
    """K14 against its plain version on each (ids, delta, worker) of
    ``cases``, gathering the same ids: values, table and state bit for
    bit under the default rule (the caller rounds table and deltas to a
    grid), within TBL_TOL otherwise; then timed on the (ids, delta)
    ``sets`` in turn, worker 0."""
    err, failed = 0.0, []
    exact = state is None
    for name, (ids, delta, worker) in zip(TBL_CASES, cases):
        a_d = table.clone()
        a_s = None if exact else state.clone()
        va = rules.rows_apply_gather(rule, a_d, a_s, ids, delta, hyp, worker,
                                     ids, C)
        dev = table.device if exact else tbl_plain_device(torch, name, table)
        b_d = table.to(dev, copy=True)
        b_s = None if exact else state.to(dev, copy=True)
        vb = rules.rows_apply_gather_plain(rule, b_d, b_s, ids.to(dev),
                                           delta.to(dev), hyp, worker,
                                           ids.to(dev), C)
        va, a_d = va.to(dev), a_d.to(dev)
        a_s = None if exact else a_s.to(dev)
        pairs = [(va, vb), (a_d, b_d)] + ([] if exact else [(a_s, b_s)])
        case_err = max(float((x - y).abs().max()) for x, y in pairs)
        err = max(err, case_err)
        if not all(torch.equal(x, y) if exact
                   else torch.allclose(x, y, **TBL_TOL) for x, y in pairs):
            failed.append(f"{name} ({case_err:g})")
        del a_d, b_d, a_s, b_s, va, vb
    ids, delta = sets[0]
    uniq = touched_rows(torch, ids, table.shape[0])
    # The update's bytes, the gather's ids and values; the rows gathered
    # are the rows just updated, which need no second read.
    n_bytes = tbl_rows_bytes(ids.numel(), delta.shape[0], uniq, C,
                             not exact) + ids.numel() * 4 \
        + ids.numel() * C * 4
    a_d = table.clone()
    a_s = None if exact else state.clone()
    result = dict(
        name="rows_apply_gather",
        tol=("bit-exact on grid-rounded deltas (values, table)" if exact
             else "rtol 1e-5 / atol 1e-7 (values, table, state)")
        + f" on {', '.join(TBL_CASES[:len(cases)])}"
        + (f"; FAILED on {failed}" if failed else ""),
        max_abs_err=err, ok=not failed,
        source="multiverso_tpu_torch/csrc/row_rules.cu",
        replaces="multiverso_tpu/updater/engine.py:155",
        ms=time_ms(torch, in_turn(
            [[s] for s in sets], lambda i, d: rules.rows_apply_gather(
                rule, a_d, a_s, i, d, hyp, 0, i, C))),
        plain_ms=time_ms(torch, in_turn(
            [[s] for s in sets], lambda i, d: rules.rows_apply_gather_plain(
                rule, a_d, a_s, i, d, hyp, 0, i, C))),
        library_ms=None,
        bound=bound(n_bytes,
                    TBL_FLOPS[rule] * touched_ids(torch, ids, table) * C))
    del a_d, a_s
    return result


def tbl_edge_ids(np, rows, R: int):
    """The bench's ids with the edges of the id contract: the pad
    sentinel, ids past it, wrapped negatives (alone, and beside their
    positive twins: -10 and -R) and ids below -R, some past the delta's
    rows; and the bench's ids with one row at 4,096 positions."""
    from multiverso_tpu_torch.updater.engine import pad_ids
    edges = pad_ids(rows, R)
    n = rows.size
    at = [3, 77, n // 20, n // 3, n // 2 + 1, 3 * n // 4, n - 2,
          (n + edges.size) // 2, edges.size - 1]  # the last two: no delta
    edges[at] = [R, R + 3, -1, -R, -(R + 2), R - 1, -2, 2 ** 30, -10]
    run = pad_ids(rows, R)
    run[1000:1000 + 4096] = run[1000]
    return edges, run


def tbl_kernel_checks(torch, np, device, card: str):
    """Phase 10a: K13, K14, K2 and K3 against their plain versions at the
    bench's shapes, then timed on TBL_ROTATE sets of ids and deltas in
    turn (each set's rows, a row's state and delta fill most of L2).
    Returns {path: [results]}."""
    from multiverso_tpu_torch.kernels import rules
    from multiverso_tpu_torch.updater import AddOption
    from multiverso_tpu_torch.updater.engine import pad_ids
    R, C, S = TBL_ROWS, TBL_COLS, 128  # storage pads 50 columns to 128
    gen = torch.Generator(device=device)
    gen.manual_seed(10)
    table = torch.randn((R, S), generator=gen, device=device) * 0.1
    table[:, C:] = 0.0
    rows = np.arange(R // TBL_EVERY, dtype=np.int32) * TBL_EVERY
    # Set j takes rows j, 10 + j, ...: the same shapes on other rows.
    sets = [(torch.from_numpy(pad_ids(rows + j, R)).to(device),
             torch.randn((rows.size, C), generator=gen, device=device)
             * 0.01) for j in range(TBL_ROTATE)]
    ids, delta = sets[0]
    # 5% of the positions repeat another position's row.
    rng = np.random.default_rng(11)
    dup_np = pad_ids(rows, R)
    pick = rng.choice(rows.size, rows.size // 20, replace=False)
    dup_np[pick] = rows[rng.integers(0, rows.size, pick.size)]
    dup = torch.from_numpy(dup_np).to(device)
    edges, run = (torch.from_numpy(x).to(device)
                  for x in tbl_edge_ids(np, rows, R))
    hyp = AddOption(**TBL_HYP).hyper_array()
    # In TBL_CASES' order; worker 1 is past the one slot. The row at
    # 4,096 positions takes deltas of both signs, whose steps cancel in
    # the sum: K13 adds them in position order (one warp walks the run),
    # as the plain version does on the CPU, and forms AdaGrad's step as
    # 1/sqrt in correctly rounded operations, as the plain version does,
    # so the two agree step for step.
    cases = [(ids, delta, 0), (dup, delta, 0), (edges, delta, 0),
             (run, delta, 0), (ids, delta, 1)]
    out = {}
    for suffix, _, replaces in TBL_RULES:
        state = tbl_state(torch, suffix, table, gen)
        out[f"tbl_dirty_{suffix}"] = [tbl_check_rule(
            torch, rules, suffix, replaces, table, state, cases, sets, hyp,
            C)]
        out[f"tbl_fused_{suffix}"] = [tbl_check_fused(
            torch, rules, suffix, table, state, cases, sets, hyp, C)]
        del state
    # The grid of the deltas' largest sum: the row at 4,096 positions.
    base, grid_delta = on_grid(torch, table, run, delta)
    out["tbl_fused_default"] = [tbl_check_fused(
        torch, rules, "default", base, None,
        [(i, grid_delta, 0) for i in (ids, dup, edges, run)], sets, hyp, C)]
    gather = check_gather(torch, [(table, ids)], C,
                          rotate=[[(table, i)] for i, _ in sets[1:]])
    out["tbl_dirty_default"] = [check_scatter(
        torch, [(table, ids, delta)], C,
        rotate=[[(table, i, d)] for i, d in sets[1:]]), gather]
    for suffix, _, _ in TBL_RULES:
        out[f"tbl_dirty_{suffix}"].append(dict(gather))
    del table, base, grid_delta, sets
    for path, entries in out.items():
        report(entries, card, path)
    return out


def tbl_profile(torch, path: str, rounds, workdir: str, profile_dir: str,
                n_rounds: int):
    """(device ms a round of kernels, busy share) of ``n_rounds`` more
    rounds under torch.profiler."""
    import torch.profiler as tp
    with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            rounds()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = os.path.join(profile_dir or workdir, f"{path}_trace.json")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
    _, busy_ms, kernel_ms = trace_kernels(prof, trace)
    return kernel_ms / n_rounds, busy_ms / (wall * 1e3)


def tbl_drive(torch, path: str, card: str, need, one_round, round_bytes,
              workdir: str, profile_dir: str, iters: int, check):
    """TBL_WARM rounds, then ``iters`` counted with the launch counts reset
    just before and read just after (ms a round on the host clock,
    synced; the bench's GB/s; the host monitors), ``check`` on the last
    round's result, then, on the card (``need`` not None: the kernels
    that must have launched), ``iters`` rounds profiled. Returns the
    counts."""
    from multiverso_tpu_torch import kernels
    from multiverso_tpu_torch.util.dashboard import Dashboard
    cuda = need is not None
    for _ in range(TBL_WARM):
        one_round()
    if cuda:
        torch.cuda.synchronize()
    Dashboard.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        last = one_round()
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = kernels.launch_counts()
    monitors = Dashboard.display()
    check(last)
    ms = elapsed / iters * 1e3
    line = (f"[{path}] {card} | {iters} rounds in {elapsed:.4f}s | "
            f"{ms:.3f} ms a round | {round_bytes / (ms / 1e3) / 1e9:.3f} "
            f"GB/s (bench bytes {round_bytes}) | kernel launches "
            f"{ {k: v for k, v in counts.items() if v} }")
    if cuda:
        missing = [n for n in need if counts[n] <= 0]
        if missing:
            raise AssertionError(f"{path} never launched {missing}")
        dev_ms, busy = tbl_profile(torch, path, one_round, workdir,
                                   profile_dir, iters)
        line += f" | profiled: device {dev_ms:.4f} ms a round, busy {busy:.1%}"
    log(line)
    for entry in monitors.splitlines():
        log(f"[{path}] {entry}")
    return counts


def tbl_dense_path(torch, np, mv, device, card: str, workdir: str,
                   profile_dir: str, R: int, C: int):
    """``tbl_dense``: whole-table adds of a device delta, then
    ``get_device`` (bench.py:3599-3620: ones, so every sum is exact)."""
    cuda = device.type == "cuda"
    mv.init([], device=None if cuda else "cpu")
    try:
        table = mv.create_matrix_table(R, C)
        delta = torch.ones((R, C), device=device)
        added = [0]

        def add_round():
            table.add(delta)
            added[0] += 1

        def check_add(_):
            got = table.get_device()
            if not bool((got == float(added[0])).all()):
                raise AssertionError("tbl_dense: the adds did not sum")

        nbytes = R * C * 4
        tbl_drive(torch, "tbl_dense add", card, () if cuda else None,
                  add_round, nbytes, workdir, profile_dir, TBL_ITERS,
                  check_add)

        def check_get(got):
            if tuple(got.shape) != (R, C) or got.device != device \
                    or not bool((got == float(added[0])).all()):
                raise AssertionError("tbl_dense: bad get_device reply")

        counts = tbl_drive(torch, "tbl_dense get_device", card,
                           () if cuda else None, table.get_device, nbytes,
                           workdir, profile_dir, TBL_ITERS, check_get)
        del table, delta
    finally:
        mv.shutdown()
    return counts


def tbl_sparse_paths(torch, np, mv, device, card: str, workdir: str,
                     profile_dir: str, R: int, C: int, rule: str,
                     updater_type):
    """The dirty and fused paths of one rule on one sparse table: the
    bench's options under the default rule (worker 1 adds, worker 0
    reads; the fused round with a device mirror of the ids); on a
    pipelined table under a stateful rule (the composed rounds add as
    worker -1, which dirties every consumer and takes worker 0's state;
    the fused rounds add as worker 0 and read consumer 1, host ids).
    The last counted round's values are checked against a shadow table
    that the plain rule brings up to date outside the timed rounds."""
    from multiverso_tpu_torch.kernels import rules as krules
    from multiverso_tpu_torch.updater import AddOption, create_rule
    from multiverso_tpu_torch.updater.engine import pad_ids
    cuda = device.type == "cuda"
    stateful = rule != "default"
    mv.init([], device=None if cuda else "cpu")
    counts = {}
    try:
        sparse = mv.create_matrix_table(R, C, is_sparse=True,
                                        is_pipeline=stateful,
                                        updater_type=updater_type)
        sparse.get_dirty_device()  # the initial full sync of consumer 0
        rows = np.arange(R // TBL_EVERY, dtype=np.int32) * TBL_EVERY
        gen = torch.Generator(device=device)
        gen.manual_seed(12)
        dev_delta = torch.randn((rows.size, C), generator=gen,
                                device=device) * 0.01
        if not stateful:  # multiples of 2^-16: every sum is exact
            dev_delta = torch.round(dev_delta * 65536) / 65536
        dev_ids = torch.from_numpy(pad_ids(rows, R)).to(device)
        hyp = AddOption(**TBL_HYP).hyper_array()
        shadow = torch.zeros((R, C), device=device)
        shadow_state = create_rule(updater_type).init_state(
            (R, C), np.float32, 1, device) if stateful else None

        pending = [0]  # rounds the shadow has not taken yet

        def check(result):
            for _ in range(pending[0]):
                if stateful:
                    krules.row_rule_apply_plain(rule, shadow, shadow_state,
                                                dev_ids, dev_delta, hyp, 0)
                else:
                    shadow[torch.from_numpy(rows).to(device)] += dev_delta
            pending[0] = 0
            ids, vals = result
            if not np.array_equal(ids, rows):
                raise AssertionError(f"{rule}: dirty ids are not the added "
                                     f"rows ({ids.size} ids)")
            want = shadow[torch.from_numpy(rows).to(device)]
            same = torch.equal(vals, want) if not stateful \
                else torch.allclose(vals, want, **TBL_TOL)
            if not same:
                raise AssertionError(f"{rule}: dirty values disagree with "
                                     f"the shadow table (max "
                                     f"{float((vals - want).abs().max()):g})")

        composed = AddOption(worker_id=-1 if stateful else 1, **TBL_HYP)
        fused = AddOption(worker_id=0 if stateful else 1, **TBL_HYP)
        reader = 1 if stateful else 0

        def dirty_round():
            sparse.add_rows(rows, dev_delta, option=composed)
            pending[0] += 1
            return sparse.get_dirty_device()

        def fused_round():
            mirror = None if stateful else dev_ids
            result = sparse.add_get_dirty_device(
                rows, dev_delta, option=fused, get_worker=reader,
                row_ids_device=mirror)
            pending[0] += 1
            return result

        round_bytes = rows.size * C * 4 * 2  # bench.py:3661
        need = (["row_scatter_add", "row_gather"] if not stateful
                else ["row_rule_apply", "row_gather"]) if cuda else None
        counts[f"tbl_dirty_{rule}"] = tbl_drive(
            torch, f"tbl_dirty_{rule}", card, need, dirty_round, round_bytes,
            workdir, profile_dir, TBL_ITERS, check)
        if stateful:
            # Consumer 1's first read returns every row it has not read.
            fused_round()
        counts[f"tbl_fused_{rule}"] = tbl_drive(
            torch, f"tbl_fused_{rule}", card,
            ["rows_apply_gather"] if cuda else None, fused_round,
            round_bytes, workdir, profile_dir, TBL_ITERS, check)
        del sparse, dev_delta, shadow, shadow_state
    finally:
        mv.shutdown()
    return counts


def tbl_small_sequence(torch, np, mv, device, updater_type: str):
    """The tests' op sequence (tests/test_torch_sparse_device.py) on a
    pipelined 64 x 5 table with duplicate ids: adds, dirty Gets and
    fused rounds; returns every id vector, value, table and state."""
    from multiverso_tpu_torch.updater import AddOption
    mv.init([], device=None if device.type == "cuda" else "cpu")
    out = {}
    try:
        t = mv.create_matrix_table(64, 5, is_sparse=True, is_pipeline=True,
                                   updater_type=updater_type)
        server = mv.current_zoo().server_tables[t.table_id]
        rng = np.random.default_rng(7)
        rows = np.array([2, 9, 40, 9, 63, 2], np.int32)

        def delta(k):
            return torch.from_numpy((rng.standard_normal((k, 5)) * 0.05)
                                    .astype(np.float32)).to(device)

        def keep(tag, result):
            out[f"ids_{tag}"] = result[0]
            out[f"vals_{tag}"] = result[1].cpu().numpy()

        keep("init", t.get_dirty_device())
        composed = AddOption(worker_id=-1, **TBL_HYP)
        fused = AddOption(worker_id=0, **TBL_HYP)
        for i in range(3):
            t.add_rows(rows, delta(rows.size), option=composed)
            keep(f"dirty{i}", t.get_dirty_device())
            sub = rows[:4] if i == 1 else rows
            keep(f"fused{i}", t.add_get_dirty_device(
                sub, delta(sub.size), option=fused, get_worker=1))
        out["table"] = server.raw.cpu().numpy()
        state = server._engine.state
        if state is not None:
            out["state"] = state.cpu().numpy()
    finally:
        mv.shutdown()
    return out


def run_table_phase(torch, np, mv, device, card: str, workdir: str,
                    profile_dir: str, rehearsal: bool):
    """Phase 10: the table data plane (bench.py matrix_bandwidth). Returns
    (kernel results, launch counts per ``tbl_*`` path)."""
    cuda = device.type == "cuda"
    R = TBL_ROWS // 1000 if rehearsal else TBL_ROWS
    results = []
    checks = tbl_kernel_checks(torch, np, device, card) if cuda else {}
    free(torch, device)
    counts = {"tbl_dense": tbl_dense_path(torch, np, mv, device, card,
                                          workdir, profile_dir, R, TBL_COLS)}
    free(torch, device)
    for rule, updater_type in (("default", None),) + tuple(
            (suffix, ut) for suffix, ut, _ in TBL_RULES):
        counts.update(tbl_sparse_paths(torch, np, mv, device, card, workdir,
                                       profile_dir, R, TBL_COLS, rule,
                                       updater_type))
        free(torch, device)
    for path, entries in checks.items():
        for entry in entries:
            entry["path"] = path
            results.append(entry)
    for updater_type in ("default", "momentum_sgd", "adagrad", "dcasgd"):
        got = tbl_small_sequence(torch, np, mv, device, updater_type)
        ref = tbl_small_sequence(torch, np, mv, torch.device("cpu"),
                                 updater_type)
        if got.keys() != ref.keys():
            raise AssertionError(f"small table sequence {updater_type}: "
                                 f"{sorted(got)} vs {sorted(ref)}")
        for key in ref:
            if key.startswith("ids_"):
                if not np.array_equal(got[key], ref[key]):
                    raise AssertionError(f"small table sequence "
                                         f"{updater_type}: {key} differ")
            else:
                np.testing.assert_allclose(
                    got[key], ref[key], rtol=1e-4, atol=1e-6,
                    err_msg=f"small table sequence {updater_type} {key}")
        log(f"[small input] table sequence {updater_type}: card vs CPU "
            f"plain path: {len(ref)} arrays (ids, values, table, state) "
            f"agree (ids exactly, the rest rtol 1e-4 / atol 1e-6)")
    return results, counts


# -- phase 11: several servers in one process --

# (path, servers, segmented): the main path (PS SGNS at phase 2's
# settings) over LocalCluster(n, roles=["all"] + ["server"] * (n - 1)),
# the device keys broadcast to every server or cut per server.
MS_PATHS = (("ps_2srv", 2, False), ("ps_4srv", 4, False),
            ("ps_2srv_seg", 2, True), ("ps_4srv_seg", 4, True))
# Block id sets timed in turn (blocks 0-4: other rows, so that no call
# finds its rows in L2).
MS_ROTATE = 5
_MS_SRC = {"row_gather_bounded": _CSRC + "row_gather.cu",
           "row_scatter_add_bounded": _CSRC + "row_scatter_add.cu",
           "segment_merge": _CSRC + "segments.cu",
           "segment_split": _CSRC + "segments.cu"}
_MS_REF = {"row_gather_bounded":
           "multiverso_tpu/tables/matrix_table.py:2777",
           "row_scatter_add_bounded": "multiverso_tpu/updater/engine.py:132",
           "segment_merge": _REF + "878",
           "segment_split": _REF + "824"}


def ms_cluster(n: int, device):
    from multiverso_tpu_torch.runtime.cluster import LocalCluster
    cluster = LocalCluster(n, roles=["all"] + ["server"] * (n - 1),
                           device=str(device))
    cluster.timeout = 900.0
    return cluster


def ms_run(cluster, make_model, work):
    """``make_model()`` on every rank of ``cluster`` (table creation is
    collective), then ``work(model)`` on rank 0, whose result is
    returned; the server ranks mirror each of rank 0's barriers (one an
    epoch) until it is done. A failure on rank 0 aborts the servers."""
    import threading
    from multiverso_tpu_torch import current_zoo
    done = threading.Event()

    def body(rank):
        model = make_model()
        zoo = current_zoo()
        if rank:
            while True:
                zoo.barrier()
                if done.is_set():
                    return None
        result = work(model)
        done.set()
        zoo.barrier()
        return result

    return cluster.run(body)[0]


def ms_entry(name: str, tol: str, err: float, ok: bool, ms: float,
             plain_ms: float, n_bytes: float):
    return dict(name=name, tol=tol, max_abs_err=float(err), ok=ok,
                source=_MS_SRC[name], replaces=_MS_REF[name], ms=ms,
                plain_ms=plain_ms, library_ms=None, bound=bound(n_bytes))


def ms_edge_ids(torch, ofs: int, n: int, R: int, device):
    """The edges of a server window's rule: ofs-1, ofs, ofs+n-1, ofs+n,
    -1, -R, the pad sentinel R, ids past it."""
    return torch.tensor([ofs - 1, ofs, ofs + n - 1, ofs + n, -1, -R, R,
                         R + 7, 2 ** 30, ofs], dtype=torch.int32,
                        device=device)


def ms_owned(torch, ids, ofs: int, n: int):
    """(occurrences of ``ids`` in the window, distinct rows they reach)."""
    flat = ids.reshape(-1).to(torch.int64)
    own = flat[(flat >= ofs) & (flat < ofs + n)]
    return int(own.numel()), int(torch.unique(own).numel())


def ms_gather(torch, calls, edges, D: int):
    """K15 on ``calls``, lists (one a set of rows) of (shard, ids, ofs, n)
    as a block launches them, and on the ``edges`` calls: bit-exact on
    the first set and the edges, timed over a block's calls, the sets in
    turn."""
    from multiverso_tpu_torch.kernels import rows
    err, n_bytes = 0.0, 0
    for shard, ids, ofs, n in calls[0] + edges:
        got = rows.row_gather_bounded(shard, ids, ofs, n, D)
        err = max(err, float((got - rows.row_gather_bounded_plain(
            shard, ids, ofs, n, D)).abs().max()))
    for shard, ids, ofs, n in calls[0]:
        k = ids.numel()
        n_bytes += k * 4 + k * D * 4 + ms_owned(torch, ids, ofs, n)[1] * D * 4
    return ms_entry(
        "row_gather_bounded", "bit-exact (every server's window, edge ids)",
        err, err == 0.0,
        time_ms(torch, in_turn(calls, lambda t, i, o, n:
                               rows.row_gather_bounded(t, i, o, n, D))),
        time_ms(torch, in_turn(calls, lambda t, i, o, n:
                               rows.row_gather_bounded_plain(t, i, o, n, D))),
        n_bytes)


def ms_scatter(torch, calls, edges, D: int):
    """K16 on ``calls``, lists of (shard, ids, delta, ofs, n), and on the
    ``edges`` calls, each rounded ``on_grid``: bit-exact on the first set
    and the edges; timed as ``ms_gather``, on clones of the shards."""
    from multiverso_tpu_torch.kernels import rows
    err, n_bytes = 0.0, 0
    for shard, ids, delta, ofs, n in calls[0] + edges:
        base, grid_delta = on_grid(torch, shard, ids, delta)
        a = base.clone()
        rows.row_scatter_add_bounded(a, ids, grid_delta, ofs, n, 1.0)
        rows.row_scatter_add_bounded_plain(base, ids, grid_delta, ofs, n,
                                           1.0)
        err = max(err, float((a - base).abs().max()))
        del a, base, grid_delta
    for shard, ids, delta, ofs, n in calls[0]:
        own, uniq = ms_owned(torch, ids.reshape(-1)[:delta.shape[0]], ofs, n)
        n_bytes += ids.numel() * 4 + own * D * 4 + 2 * uniq * D * 4
    clones = {}
    sets = [[(clones.setdefault(id(t), t.clone()), i, d, o, n)
             for t, i, d, o, n in c] for c in calls]
    result = ms_entry(
        "row_scatter_add_bounded",
        "bit-exact on grid-rounded deltas (every server's window, edge "
        "ids)", err, err == 0.0,
        time_ms(torch, in_turn(sets, lambda t, i, d, o, n:
                               rows.row_scatter_add_bounded(t, i, d, o, n))),
        time_ms(torch, in_turn(sets, lambda t, i, d, o, n: rows.
                               row_scatter_add_bounded_plain(t, i, d, o, n))),
        n_bytes)
    del sets, clones
    return result


def ms_valid_rows(bounds, caps, n: int) -> int:
    """Rows of the S segments that copy a source row (the rest fill)."""
    b = [int(x) for x in bounds.cpu()]
    return sum(max(min(cap, n - b[s]), 0) for s, cap in enumerate(caps))


def ms_segments(torch, preps, D: int):
    """K18 (ids and deltas) and K17 on ``preps``, lists (one a set of
    rows) of (segmented ids, pad sentinel, the ids, the reply parts, the
    push delta) as a block launches them: bit-exact on the first set,
    timed over a block's calls, the sets in turn."""
    from multiverso_tpu_torch.kernels import segments as ks

    def splits(seg, oor, ids, parts, delta, plain=False):
        fn = ks.segment_split_plain if plain else ks.segment_split
        return (fn(ids.reshape(-1), seg.order, seg.bounds, seg.caps, oor)
                + fn(delta, seg.order, seg.bounds, seg.caps))

    def merges(seg, oor, ids, parts, delta, plain=False):
        fn = ks.segment_merge_plain if plain else ks.segment_merge
        return fn(parts, seg.bounds, seg.inv, seg.caps)

    split_err, merge_err = 0.0, 0.0
    split_bytes = merge_bytes = 0
    for case in preps[0]:
        seg, _, ids, _, delta = case
        for g, r in zip(splits(*case), splits(*case, plain=True)):
            split_err = max(split_err, float(
                (g.double() - r.double()).abs().max()))
        n = ids.numel()
        valid = ms_valid_rows(seg.bounds, seg.caps, n)
        split_bytes += sum(valid * (8 + width * 4) + sum(seg.caps) * width * 4
                           for width in (1, delta.shape[1]))
        merge_err = max(merge_err, float(
            (merges(*case) - merges(*case, plain=True)).abs().max()))
        # The inverse permutation and the rows written; each row read
        # from its owner's reply (or none past a capacity).
        merge_bytes += n * 8 + 2 * n * D * 4
    return [
        ms_entry("segment_split",
                 "bit-exact (ids and deltas, every server's segment)",
                 split_err, split_err == 0.0,
                 time_ms(torch, in_turn(preps, splits)),
                 time_ms(torch, in_turn(preps, lambda *c: splits(
                     *c, plain=True))), split_bytes),
        ms_entry("segment_merge", "bit-exact (zeros past a capacity)",
                 merge_err, merge_err == 0.0,
                 time_ms(torch, in_turn(preps, merges)),
                 time_ms(torch, in_turn(preps, lambda *c: merges(
                     *c, plain=True))), merge_bytes)]


def ms_step_kernel(torch, trainer, table_in, table_out):
    """K4 at block 0's call, as ``check_kernels`` holds it."""
    kernel, plain, args, n_bytes, flops, _ = step_kernel_case(
        torch, trainer, table_in, table_out)
    err, ok, loss_rel = compare_step(kernel(*args), plain(*args))
    return dict(
        name="banded_sgns_grad", tol=f"grads |err| <= 1e-5 + 1e-4 |plain|; "
        f"loss rel err {loss_rel:.2g} <= 1e-5; counts equal",
        max_abs_err=err, ok=ok, source=_CSRC + "banded_sgns.cu",
        replaces=_REF + "729", ms=time_ms(torch, lambda: kernel(*args)),
        plain_ms=time_ms(torch, lambda: plain(*args)), library_ms=None,
        bound=bound(n_bytes, flops))


def ms_kernel_checks(torch, trainer, path: str, seg: bool, card: str):
    """Phase 11a: every kernel of a several-server path against its plain
    version on the card: K1 on the epoch's uniforms, K4 at block 0's
    call; K15 and K16 at blocks 0-4's pulls and pushes (``ps_group_case``
    over random tables) on every server's window, and on each window's
    edge ids; segmented, K18 cutting the ids and the push deltas, K15 and
    K16 on each server's segment and K17 on the servers' replies. Times
    are over the calls of one block, the 5 blocks' rows in turn."""
    from multiverso_tpu_torch.kernels import rows
    model = trainer.model
    D = trainer.config.embedding_size
    offsets = model._in_table._offsets
    R = model._in_table.num_row
    windows = [(offsets[s], offsets[s + 1] - offsets[s])
               for s in range(len(offsets) - 1)]
    table_in, table_out = random_tables(torch, trainer.device,
                                        model_shapes(model))
    u = trainer._draws.epoch_uniforms(1234, trainer._corpus.n_tokens)
    results = [check_subsample(torch, trainer._corpus, u),
               ms_step_kernel(torch, trainer, table_in, table_out)]
    shards = [[(t[o:o + n], o, n) for o, n in windows]
              for t in (table_in, table_out)]
    gathers, scatters, preps = [], [], []
    for first in range(MS_ROTATE):
        cases = ps_group_case(torch, trainer, u, table_in, table_out, first)
        g, sc, pr = [], [], []
        for side, (_, ids, delta) in enumerate(cases):
            if not seg:
                g += [(t, ids, o, n) for t, o, n in shards[side]]
                sc += [(t, ids, delta, o, n) for t, o, n in shards[side]]
                continue
            segmenter = trainer._seg_ids[side]
            sg = segmenter.prep(ids)
            parts = [rows.row_gather_bounded(t, i, o, n, D)
                     for (t, o, n), i in zip(shards[side], sg.segments)]
            pr.append((sg, segmenter.oor, ids, parts, delta))
            for (t, o, n), i, d in zip(shards[side], sg.segments,
                                       sg.split(delta)):
                g.append((t, i, o, n))
                sc.append((t, i, d, o, n))
        gathers.append(g)
        scatters.append(sc)
        preps.append(pr)
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(11)
    edges = [(t, ms_edge_ids(torch, o, n, R, trainer.device), o, n)
             for t, o, n in shards[0]]
    results.append(ms_gather(torch, gathers, edges, D))
    results.append(ms_scatter(torch, scatters, [
        (t, i, torch.randn(i.numel(), D, generator=gen,
                           device=trainer.device) * 1e-2, o, n)
        for t, i, o, n in edges], D))
    if seg:
        results += ms_segments(torch, preps, D)
    del gathers, scatters, preps, shards, table_in, table_out
    return report(results, card, path)


def ms_small_run(torch, mv, device, workdir: str, n: int, seg: bool):
    """The tests' topic corpus through ``LocalCluster(n)`` (PS SGNS, 6
    blocks of 128 centers, draws from one CPU generator): (losses a
    block, examples, in rows, out rows)."""
    import numpy as np
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
        TorchDraws, Word2VecConfig)
    path = write_topics(workdir)
    dictionary = Dictionary.build(path, min_count=1)
    tokenized = TokenizedCorpus.build(dictionary, path)
    config = Word2VecConfig(embedding_size=16, window=3, negative=5,
                            epochs=2, min_count=1, sample=1e-2, use_ps=True,
                            neg_block=8)

    def work(model):
        trainer = PSDeviceCorpusTrainer(
            model, tokenized, centers_per_step=128, segment_keys=seg,
            draws=TorchDraws(device, draw_device="cpu"))
        losses = []
        _, examples = trainer.train_epoch(
            seed=5, max_steps=6, block_hook=lambda _w: losses.append(
                float(trainer.last_loss)))
        if (trainer._seg_ids is not None) != seg:
            raise AssertionError("segmented keys not taken as asked")
        return (np.array(losses), examples, model._in_table.get(),
                model._out_table.get())

    return ms_run(ms_cluster(n, device),
                  lambda: PSWord2Vec(config, dictionary), work)


def run_multiserver_phase(torch, np, mv, device, dictionary, tokenized,
                          card: str, workdir: str, profile_dir: str,
                          dim: int, scale_down: int):
    """Phase 11: the main path (PS SGNS at phase 2's settings) over
    ``LocalCluster(n, roles=["all"] + ["server"] * (n - 1))`` on one card,
    for each of MS_PATHS: every kernel of the path against its plain
    version (``ms_kernel_checks``), a counted run of BLOCKS blocks (every
    kernel of the path launched, summed over the servers; words/s, then
    profiled), finite tables, and the topic corpus trained through the
    same cluster shape on the card and on the CPU with the same draws.
    Returns (kernel results, launch counts per path)."""
    from multiverso_tpu_torch.models.wordembedding import (
        PSDeviceCorpusTrainer, PSWord2Vec, Word2VecConfig)
    results, counts = [], {}
    config = Word2VecConfig(embedding_size=dim, window=WINDOW, negative=NEG,
                            epochs=3, min_count=1, sample=1e-3, use_ps=True,
                            neg_block=NEG_BLOCK)
    for path, n, seg in MS_PATHS:
        t0 = time.perf_counter()
        need = ["subsample_compact", "row_gather_bounded",
                "banded_sgns_grad", "row_scatter_add_bounded"]
        if seg:
            need += ["segment_split", "segment_merge"]

        def work(model, path=path, seg=seg, need=need):
            trainer = PSDeviceCorpusTrainer(model, tokenized,
                                            CENTERS // scale_down,
                                            segment_keys=seg)
            log(f"[{path}] {n} servers, model + trainer "
                f"{time.perf_counter() - t0:.1f}s | offsets "
                f"{model._in_table._offsets} | C={trainer._C}")
            trainer.train_epoch(seed=99, max_steps=1)  # warm-up, calibrates
            if seg:
                log(f"[{path}] segment capacities: in "
                    f"{trainer._seg_ids[0].caps}, out "
                    f"{trainer._seg_ids[1].caps}")
            checks = []
            if device.type == "cuda":
                checks = ms_kernel_checks(torch, trainer, path, seg, card)
            path_counts = drive_counted(
                torch, model, path, need, card, workdir, profile_dir,
                lambda: trainer.train_epoch(seed=0, max_steps=BLOCKS),
                BLOCKS, "block")
            check_tables(np, model, path)
            return checks, path_counts

        checks, counts[path] = ms_run(
            ms_cluster(n, device), lambda: PSWord2Vec(config, dictionary),
            work)
        results += checks
        free(torch, device)
        compare_small(np, f"{path}, 6 blocks",
                      ms_small_run(torch, mv, device, workdir, n, seg),
                      ms_small_run(torch, mv, torch.device("cpu"), workdir,
                                   n, seg))
    return results, counts


# -- phase 12: model averaging (B16) --

# ma_mesh4: the device MA group (_ma_group_fn) on MA_SLOTS replica slots
# of one card at the local SGNS settings (bench.py:135-149); ma_ranks:
# MACorpusTrainer over LocalCluster(MA_RANKS, ["-ma=true"]); ma_sgd4:
# MASGDStep on MA_SLOTS slots (the reference test's linear regression).
MA_SLOTS, MA_C, MA_G, MA_GROUPS = 4, 16384, 16, 4
MA_RANKS, MA_AVG_EVERY, MA_RANK_GROUPS = 2, 4, 8
MA_SGD_STEPS, MA_SGD_BATCH = 60, 16
_MA_SRC = _CSRC + "mesh_reduce.cu"


def time_events_ms(torch, fn, reps: int = REPS) -> float:
    """Wall time of one ``fn()`` call on the stream: CUDA events around
    ``reps`` calls after warm-up, divided by ``reps`` (for calls of a
    millisecond or more, where the launch gaps are hidden)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ma_k19_check(torch, x, replaces: str, mean: bool, copies: int):
    """K19 on ``x`` [n, M] in one form against its plain version on the
    same input: bit-exact (compared as int32 bit patterns), timed beside
    the one PyTorch call of the same function (``x.mean(0)`` or
    ``torch.sum(x, 0)``: another summation order, timed only). Inputs
    past 64 MB are timed with CUDA events over ``REPS`` calls: there
    ``time_ms``'s profiler sums have read below the byte bound (PERF.md
    §6); smaller ones with ``time_ms``, whose events would time the
    launches."""
    from multiverso_tpu_torch.kernels import mesh
    n, m = x.shape
    got = mesh.mesh_allreduce(x, mean, copies)
    ref = mesh.mesh_allreduce_plain(x, mean, copies)
    same = bool(torch.equal(got.view(torch.int32), ref.view(torch.int32)))
    err = float((got - ref).abs().max())
    del got, ref
    library = (lambda: x.mean(0)) if mean else (lambda: torch.sum(x, 0))
    timer = time_events_ms if n * m * 4 > 64 << 20 else time_ms
    return dict(
        name="mesh_allreduce", tol=f"bit-exact ({'mean' if mean else 'sum'}"
        f", {n} slots, copies {copies}, M={m})", max_abs_err=err, ok=same,
        source=_MA_SRC, replaces=replaces,
        ms=timer(torch, lambda: mesh.mesh_allreduce(x, mean, copies)),
        plain_ms=timer(torch, lambda: mesh.mesh_allreduce_plain(
            x, mean, copies)),
        library_ms=timer(torch, library),
        bound=bound((n + copies) * m * 4))


def ma_spread_values(torch, shape, device, seed: int):
    """Seeded normal values over 16 binades: a sum of them rounds, so an
    order other than the slot order would show."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    x.mul_(torch.exp2(torch.randint(-8, 8, shape, generator=gen,
                                     device=device).float()))
    return x


def ma_slot_draws(device, n: int, draw_device=None):
    """One ``TorchDraws`` for each of n slots, slot s seeded with s."""
    from multiverso_tpu_torch.models.wordembedding import TorchDraws
    draws = [TorchDraws(device, draw_device) for _ in range(n)]
    for s, d in enumerate(draws):
        d.generator.manual_seed(s)
    return draws


def trace_kernel_ms(trace: str, needle: str) -> float:
    """Summed ms of the kernels whose name holds ``needle`` in a Chrome
    trace written by ``trace_kernels``."""
    with open(trace) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    return sum(float(e["dur"]) for e in events
               if e.get("cat") == "kernel" and "dur" in e
               and needle in e.get("name", "")) / 1e3


def ma_small_group(torch, np, device):
    """The reference test's case (tests/test_wordembedding.py
    TestMAWord2Vec: C 64, W 2, K 3, 512 kept tokens a slot, V 40, D 8,
    G 2, 8 slots), two chained groups, draws from CPU generators:
    (losses, pairs, emb_in, emb_out)."""
    from multiverso_tpu_torch.models.wordembedding.device_train import (
        _ma_group_fn)
    from multiverso_tpu_torch.sharding.mesh import local_mesh
    C, W, K, n_local, V, D, G, n = 64, 2, 3, 512, 40, 8, 2, 8
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    emb_in = t((rng.random((V, D)).astype(np.float32) - 0.5) / D)
    emb_out = t(np.zeros((V, D), np.float32))
    kept = t(rng.integers(0, V, n * n_local).astype(np.int32))
    ksent = t(np.repeat(np.arange(n * n_local // 16, dtype=np.int32), 16))
    draws = ma_slot_draws(device, n, draw_device="cpu")
    fn = _ma_group_fn(local_mesh(n, device=device), C, W, K)
    losses, pairs = [], 0.0
    for _ in range(2):
        emb_in, emb_out, loss, p = fn(
            emb_in, emb_out, kept, ksent, t(np.ones(V, np.float32)),
            t(np.arange(V, dtype=np.int32)), draws, [0, C],
            np.full(G, 0.05, np.float32), [n_local] * n)
        losses.append(float(loss))
        pairs += float(p)
    return (np.array(losses), pairs, emb_in.cpu().numpy(),
            emb_out.cpu().numpy())


def ma_mesh_path(torch, np, device, dictionary, tokenized, card: str,
                 workdir: str, profile_dir: str, dim: int, scale_down: int):
    """``ma_mesh4``: ``_ma_group_fn`` over ``local_mesh(MA_SLOTS)`` at
    full width — the epoch's kept stream (K1) split evenly over the
    slots, each slot MA_G steps a group on its replica (K2, K4, K3),
    then K19's mean of the replicas. K1, K2, K4 and K3 are held to their
    plain versions at slot 0's first step (as phase 6), K19 bit for bit
    at the path's shape in both forms; 1 warm-up and MA_GROUPS counted
    groups (raw words/s of all slots, device ms a group, K19's share);
    finite tables; the reference test's small case card vs CPU."""
    from multiverso_tpu_torch.models.wordembedding import (
        DeviceCorpusTrainer, TorchDraws, Word2Vec, Word2VecConfig)
    from multiverso_tpu_torch.models.wordembedding.device_train import (
        _ma_group_fn)
    from multiverso_tpu_torch.sharding.mesh import local_mesh
    path = "ma_mesh4"
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    C = MA_C // scale_down
    config = Word2VecConfig(embedding_size=dim, window=WINDOW, negative=NEG,
                            epochs=3, min_count=1, sample=1e-3,
                            neg_block=NEG_BLOCK)
    model = Word2Vec(config, dictionary, device=device)
    trainer = DeviceCorpusTrainer(model, tokenized, C, MA_G)
    V, D = model._emb_in.shape
    log(f"[{path}] model + trainer {time.perf_counter() - t0:.1f}s | "
        f"{MA_SLOTS} slots of ({V}, {D}) x 2 on {device} | C={C} "
        f"G={MA_G}")
    results = []
    if cuda:
        results += check_step_kernels(
            torch, trainer, path, "banded_sgns_grad",
            _CSRC + "banded_sgns.cu", _REF + "439", card, model_shapes(model))
        x = ma_spread_values(torch, (MA_SLOTS, V * D), device, 12)
        mean_form = ma_k19_check(torch, x, _REF + "439", True, 1)
        sum_form = ma_k19_check(torch, x, _REF + "439", False, MA_SLOTS)
        del x
        free(torch, device)
        report([mean_form, sum_form], card, path)
        # The kernels line keeps the form this path runs (the mean to one
        # copy); the allreduce form's numbers are in the log above.
        results.append(mean_form)
    mesh = local_mesh(MA_SLOTS, device=device)
    T = trainer._corpus.n_tokens
    fn = _ma_group_fn(mesh, C, WINDOW, NEG, NEG_BLOCK)
    draws = ma_slot_draws(device, MA_SLOTS)
    lrs = np.full(MA_G, config.init_learning_rate, np.float32)
    epoch = {}

    def start_epoch(seed: int) -> None:
        """K1 on the epoch's uniforms; the kept stream split evenly over
        the slots."""
        kept, ksent, n_kept = trainer._corpus.prep_epoch(
            TorchDraws(device).epoch_uniforms(seed, T))
        n_kept = int(n_kept)
        n_local = n_kept // MA_SLOTS
        epoch.update(
            kept=kept[:MA_SLOTS * n_local], ksent=ksent[:MA_SLOTS * n_local],
            n_local=n_local, steps=math.ceil(n_local / C),
            # Raw corpus words a slot-step covers (the trainer's
            # accounting).
            raw=T / math.ceil(n_kept / C), n_kept=n_kept)

    def run(count: int, seed: int = 0):
        start_epoch(seed)
        loss_sum, pairs_sum = 0.0, 0.0
        for g in range(count):
            bases = [((g * MA_G + i) % epoch["steps"]) * C
                     for i in range(MA_G)]
            model._emb_in, model._emb_out, loss, pairs = fn(
                model._emb_in, model._emb_out, epoch["kept"],
                epoch["ksent"], *trainer._tables, draws, bases, lrs,
                [epoch["n_local"]] * MA_SLOTS)
            model._account_words(MA_SLOTS * MA_G * epoch["raw"])
            loss_sum += float(loss)
            pairs_sum += float(pairs)
        return loss_sum, pairs_sum

    run(1, seed=99)    # warm-up, not counted
    log(f"[{path}] kept {epoch['n_kept']} of {T} tokens: "
        f"{epoch['n_local']} a slot, {epoch['steps']} steps a slot an "
        f"epoch")
    counts = drive_counted(
        torch, model, path, ("subsample_compact", "row_gather",
                             "banded_sgns_grad", "row_scatter_add",
                             "mesh_allreduce"),
        card, workdir, profile_dir, lambda: run(MA_GROUPS), MA_GROUPS,
        "group")
    if cuda:
        trace = os.path.join(profile_dir or workdir, f"{path}_trace.json")
        k19_ms = trace_kernel_ms(trace, "mesh_allreduce")
        all_ms = trace_kernel_ms(trace, "")
        log(f"[{path}] K19 {k19_ms / MA_GROUPS:.4f} ms a group (2 calls) "
            f"of {all_ms / MA_GROUPS:.4f} device ms ({k19_ms / all_ms:.1%})"
            f"; {MA_SLOTS * MA_G} slot-steps a group")
    check_tables(np, model, path)
    del model, trainer, fn, epoch
    free(torch, device)
    compare_small(np, f"{path}: the reference test's MA group (8 slots, "
                  f"2 chained groups)", ma_small_group(torch, np, device),
                  ma_small_group(torch, np, torch.device("cpu")))
    return results, {path: counts}


def ma_sgd_run(torch, np, device):
    """The reference test's linear regression (tests/test_collectives.py
    test_ma_sgd_step_trains: y = 2x, MA_SGD_BATCH samples a slot,
    MA_SGD_STEPS steps, lr 0.1) through ``MASGDStep`` on MA_SLOTS slots:
    (w, last loss)."""
    from multiverso_tpu_torch.parallel import MASGDStep
    from multiverso_tpu_torch.sharding.mesh import local_mesh

    def loss_fn(params, batch):
        return torch.mean((params["w"] * batch[..., 0] - batch[..., 1]) ** 2)

    rng = np.random.default_rng(1)
    step = MASGDStep(loss_fn, local_mesh(MA_SLOTS, device=device), lr=0.1)
    params, loss = {"w": torch.zeros((), device=device)}, None
    for _ in range(MA_SGD_STEPS):
        x = rng.standard_normal(MA_SLOTS * MA_SGD_BATCH).astype(np.float32)
        params, loss = step(params, np.stack([x, 2 * x], axis=-1))
    return float(params["w"]), loss


def ma_sgd_path(torch, np, device, card: str):
    """``ma_sgd4``: ``MASGDStep`` on ``local_mesh(MA_SLOTS)``, with
    K19's launches counted; K19 held bit for bit at the step's shapes
    (the gradients' sum over the slots); |w - 2| < 1e-2, a loss below
    1e-3, and the card's w within 1e-6 of the CPU's."""
    from multiverso_tpu_torch import kernels
    path = "ma_sgd4"
    results = []
    if device.type == "cuda":
        x = ma_spread_values(torch, (MA_SLOTS, 1), device, 5)
        results = report([ma_k19_check(
            torch, x, "multiverso_tpu/parallel/ma.py:305", False, 1)],
            card, path)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    w, loss = ma_sgd_run(torch, np, device)
    elapsed = time.perf_counter() - t0
    counts = kernels.launch_counts()
    w_cpu, _ = ma_sgd_run(torch, np, torch.device("cpu"))
    log(f"[{path}] {card} | {MA_SGD_STEPS} steps in {elapsed:.3f}s | w "
        f"{w:.7f} (CPU {w_cpu:.7f}) | loss {loss:.3g} | K19 launches "
        f"{counts['mesh_allreduce']}")
    if not (abs(w - 2.0) < 1e-2 and loss < 1e-3 and abs(w - w_cpu) < 1e-6):
        raise AssertionError(f"{path}: w {w} (CPU {w_cpu}), loss {loss}")
    if device.type == "cuda" and counts["mesh_allreduce"] <= 0:
        raise AssertionError(f"{path} never launched mesh_allreduce")
    return results, {path: counts}


def corpus_shards(tokenized, parts: int):
    """``tokenized`` cut into ``parts`` shards of whole sentences."""
    from multiverso_tpu_torch.models.wordembedding import TokenizedCorpus
    offsets = tokenized.offsets
    cuts = [round(i * (len(offsets) - 1) / parts) for i in range(parts + 1)]
    return [TokenizedCorpus(tokenized.flat[offsets[a]:offsets[b]],
                            offsets[a:b + 1] - offsets[a])
            for a, b in zip(cuts, cuts[1:])]


def host_peak_gib() -> float:
    """This process's peak resident memory so far, in GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def max_diff(np, a, b) -> float:
    """Largest absolute difference of two float32 arrays (0.0 only when
    they are equal bit for bit, signed zeros aside)."""
    return float(np.abs(a - b).max()) if not np.array_equal(
        a.view(np.int32), b.view(np.int32)) else 0.0


def ma_ranks_path(torch, np, device, dictionary, tokenized, card: str,
                  dim: int, scale_down: int):
    """``ma_ranks``: ``MACorpusTrainer`` on every rank of
    ``LocalCluster(MA_RANKS, argv=["-ma=true"])`` on the one card, a half
    of the corpus a rank, MA_RANK_GROUPS groups of MA_G steps averaged
    every MA_AVG_EVERY groups, run with ``overlap=False``, then
    ``overlap=True``, then ``overlap=False`` again: raw words/s and
    ``MA_COMM_STALL`` of each run, the host's peak memory; every run's
    tables finite. The two modes apply the same average at the same
    point, but the card's local steps are not reproducible bit for bit
    (K3 adds duplicate ids with float atomics, in an order that varies
    from run to run), so sync against overlap must differ no more than
    10x what the two sync runs differ from each other (exactly equal
    when the sync runs are; a fault of the averaging, such as a skipped
    or misplaced average, moves values by the updates themselves,
    orders of magnitude more). Every average copies both tables to the
    host and back (the reference's design): the path is host-bound."""
    from multiverso_tpu_torch import kernels
    from multiverso_tpu_torch.models.wordembedding import (
        MACorpusTrainer, Word2Vec, Word2VecConfig)
    from multiverso_tpu_torch.runtime.cluster import LocalCluster
    from multiverso_tpu_torch.util.dashboard import Dashboard
    path = "ma_ranks"
    shards = corpus_shards(tokenized, MA_RANKS)
    config = Word2VecConfig(embedding_size=dim, window=WINDOW, negative=NEG,
                            epochs=3, min_count=1, sample=1e-3,
                            neg_block=NEG_BLOCK)
    C = MA_C // scale_down

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def body(rank, overlap):
        model = Word2Vec(config, dictionary, device=device)
        trainer = MACorpusTrainer(model, shards[rank],
                                  avg_every=MA_AVG_EVERY, overlap=overlap,
                                  centers_per_step=C, steps_per_dispatch=MA_G)
        sync()
        t0 = time.perf_counter()
        loss, examples = trainer.train_epoch(
            seed=rank, max_steps=MA_RANK_GROUPS * MA_G,
            group_quota=MA_RANK_GROUPS)
        trainer.finish()
        sync()
        return (time.perf_counter() - t0, model.trained_words, loss,
                examples, trainer.comm_rounds, model._emb_in.cpu().numpy(),
                model._emb_out.cpu().numpy())

    runs = []
    peak = host_peak_gib()
    for overlap in (False, True, False):
        cluster = LocalCluster(MA_RANKS, argv=["-ma=true"],
                               device=str(device))
        cluster.timeout = 900.0
        Dashboard.reset()
        kernels.reset_launch_counts()
        out = cluster.run(lambda r, o=overlap: body(r, o))
        stall = Dashboard.get("MA_COMM_STALL")
        wall = max(o[0] for o in out)
        words = sum(o[1] for o in out)
        mode = "overlap" if overlap else "sync"
        log(f"[{path} {mode}] {card} | {MA_RANKS} ranks x "
            f"{MA_RANK_GROUPS} groups of {MA_G} steps of {C} centers in "
            f"{wall:.3f}s | {words / wall:.0f} words/s (host-bound: every "
            f"average copies both tables to the host and back) | "
            f"{out[0][4]} averages a rank | MA_COMM_STALL {stall.count} "
            f"waits, {stall.elapse:.1f} ms | avg loss "
            f"{[round(o[2] / max(o[3], 1), 4) for o in out]}")
        counts = kernels.launch_counts()
        log(f"[{path} {mode}] kernel launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not all(np.isfinite(o[5]).all() and np.isfinite(o[6]).all()
                   and o[4] > 0 for o in out):
            raise AssertionError(f"{path} {mode}: non-finite tables or no "
                                 f"average")
        missing = [k for k in PS_KERNELS if counts[k] <= 0] \
            if device.type == "cuda" else []
        if missing:
            raise AssertionError(f"{path} {mode} never launched {missing}")
        if runs:   # the later runs: their differences from the first
            out = [[max_diff(np, a, b) for a, b in zip(first[5:], o[5:])]
                   for first, o in zip(runs[0], out)]
        runs.append(out)
    log(f"[{path}] host peak resident memory {host_peak_gib():.2f} GiB "
        f"(before the path: {peak:.2f} GiB)")
    for rank in range(MA_RANKS):
        for i, name in enumerate(("emb_in", "emb_out")):
            modes, spread = runs[1][rank][i], runs[2][rank][i]
            log(f"[{path}] rank {rank} {name}: sync vs overlap max abs "
                f"diff {modes:g}; sync vs sync {spread:g}")
            if modes > 10 * spread:
                raise AssertionError(
                    f"{path}: rank {rank} {name} differs more between sync "
                    f"and overlap ({modes:g}) than between two sync runs "
                    f"({spread:g})")
    return [], {}


def run_ma_phase(torch, np, mv, device, dictionary, tokenized, card: str,
                 workdir: str, profile_dir: str, dim: int, scale_down: int):
    """Phase 12: model averaging — ``ma_mesh4`` (the device MA group),
    ``ma_sgd4`` (``MASGDStep``) and ``ma_ranks`` (``MACorpusTrainer``
    over an ``-ma`` cluster). Returns (kernel results, launch counts per
    path)."""
    results, counts = ma_mesh_path(torch, np, device, dictionary, tokenized,
                                   card, workdir, profile_dir, dim,
                                   scale_down)
    for more in (ma_sgd_path(torch, np, device, card),
                 ma_ranks_path(torch, np, device, dictionary, tokenized,
                               card, dim, scale_down)):
        results += more[0]
        counts.update(more[1])
        free(torch, device)
    return results, counts


def kernels_line(results, counts):
    """One entry a (path, kernel): the check at that path's shapes and
    the launches of that path's own counted run."""
    return {"kernels": [dict(
        name=r["name"], path=r["path"], route="cuda", source=r["source"],
        replaces=r["replaces"], launches=int(counts[r["path"]][r["name"]]),
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound"][0], bound_by=r["bound"][1],
        library_ms=r["library_ms"]) for r in results]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="tiny CPU run of the control flow (no "
                             "kernels, no result line, exit 3)")
    parser.add_argument("--profile", metavar="DIR", default="",
                        help="also profile 8 blocks of the main path "
                             "(torch.profiler trace and host monitors "
                             "into DIR)")
    parser.add_argument("--multiserver-only", action="store_true",
                        help="build, then run phase 11 alone on the "
                             "bench corpus (no result line)")
    parser.add_argument("--ma-only", action="store_true",
                        help="build, then run phase 12 alone on the "
                             "bench corpus (no result line)")
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — the port's smoke run "
              "needs a card", file=sys.stderr)
        return 2
    try:
        import multiverso_tpu_torch as mv
    except ImportError as exc:
        print(f"chip_smoke: the multiverso_tpu_torch package is not "
              f"importable from here ({exc})", file=sys.stderr)
        return 2
    started = time.perf_counter()
    device = torch.device("cpu" if rehearsal else "cuda:0")
    card = "cpu rehearsal" if rehearsal else card_line()
    if not rehearsal:
        log(f"[env] python {sys.version.split()[0]} torch "
            f"{torch.__version__} cuda {torch.version.cuda} | {card}")
        from multiverso_tpu_torch.kernels import build
        build.library(verbose=True)
        log(f"[build] {len(build.sources())} sources compiled and linked "
            f"in {build.build_seconds:.1f}s")
        for chunk in build.build_log():
            for line in chunk.splitlines():
                if line.startswith("==") or "Used" in line \
                        or "spill" in line or "Compiling" in line:
                    log(f"[build]   {line.strip()}")
    sentences = 400 if rehearsal else None
    centers = 256 if rehearsal else CENTERS
    dim = 16 if rehearsal else DIM
    with tempfile.TemporaryDirectory(prefix="mv_chip_smoke_") as workdir:
        from multiverso_tpu_torch.models.wordembedding import synthetic
        if args.multiserver_only or args.ma_only:
            dictionary, tokenized = bench_corpus(
                workdir, sentences or synthetic.SENTENCES)
            phase = run_ma_phase if args.ma_only else run_multiserver_phase
            results, counts = phase(
                torch, np, mv, device, dictionary, tokenized, card, workdir,
                args.profile, dim, 64 if rehearsal else 1)
            print(json.dumps(kernels_line(results, counts)), flush=True)
            print(card, flush=True)
            return 3 if rehearsal else 0
        model, trainer, dictionary, tokenized = setup_main_path(
            torch, mv, device, workdir,
            sentences or synthetic.SENTENCES, centers, dim)
        # The ~1M-word dictionary and the corpus are long-lived: keep
        # the cyclic GC from re-walking them in the timed blocks (a full
        # collection of this heap takes tens of ms).
        gc.collect()
        gc.freeze()
        reuse_huffman_trees()
        results = [] if rehearsal else check_kernels(torch, trainer, card)
        counts, run, monitors = drive_main_path(torch, trainer, BLOCKS)
        report_run("main path", card, centers, run)
        losses, pairs = [float(x) for x in run[0]], run[5]
        log(f"[main path] block losses {[round(x, 2) for x in losses]}")
        log(f"[main path] kernel launches {counts}")
        for line in monitors.splitlines():
            log(f"[main path] {line}")
        # The same blocks again, not counted: the steady state.
        report_run("steady", card, centers,
                   timed_blocks(trainer, 0, BLOCKS))
        check_result(np, model, losses, pairs)
        if args.profile and not rehearsal:
            profile_main_path(torch, trainer, args.profile, card, BLOCKS)
        mv.shutdown()
        if not rehearsal:
            missing = [n for n in PS_KERNELS if counts[n] <= 0]
            if missing:
                raise AssertionError(f"main path never launched {missing}")
            compare_small(np, "ps, 6 block losses",
                          small_run(torch, mv, device, workdir),
                          small_run(torch, mv, torch.device("cpu"),
                                    workdir))
        # Phases 6-10 (the local pipeline, the PS pipeline's other
        # configurations, the host-batch trainer, logistic regression,
        # the table data plane):
        # the PS tables go first; each phase frees its models before the
        # next.
        del model, trainer
        free(torch, device)
        counts = {"ps": counts}
        common = (device, dictionary, tokenized, card, workdir,
                  args.profile, dim, 64 if rehearsal else 1)
        phases = (lambda: run_local_phase(torch, np, *common),
                  lambda: run_ps_modes_phase(torch, np, mv, *common),
                  lambda: run_hostbatch_phase(torch, np, mv, *common),
                  lambda: run_logreg_phase(torch, np, mv, device, card,
                                           workdir, args.profile,
                                           rehearsal),
                  lambda: run_table_phase(torch, np, mv, device, card,
                                          workdir, args.profile,
                                          rehearsal),
                  lambda: run_multiserver_phase(torch, np, mv, *common),
                  lambda: run_ma_phase(torch, np, mv, *common))
        for number, phase in enumerate(phases, 6):
            t0 = time.perf_counter()
            phase_results, phase_counts = phase()
            results += phase_results
            counts.update(phase_counts)
            log(f"[phase {number}] {time.perf_counter() - t0:.1f}s")
    log(f"[done] {time.perf_counter() - started:.1f}s")
    if rehearsal:
        return 3
    print(json.dumps(kernels_line(results, counts)), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
