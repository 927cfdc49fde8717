#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multiverso_tpu_torch``) on one
CUDA card.

Phases, each fatal on failure:

1. build the twenty-one hand-written kernels from
   ``multiverso_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together, ``-ftz=true``) and print the build time, ``ptxas`` resource
   usage and how many of the library's float adds, multiplies and fused
   multiply-adds flush subnormals (``.FTZ`` in its SASS);
2. set up the main path at the benchmark's full width: the synthetic
   corpus of ``bench.py`` (``models/wordembedding/synthetic.py``, ~6M
   tokens, ~1M-word dictionary), ``mv.init([])`` on ``cuda:0``,
   ``PSWord2Vec`` (D=128, window 5, 5 negatives, neg_block 8) over two
   ~1M-row matrix tables, ``PSDeviceCorpusTrainer`` with 32768 centers a
   block;
3. hold every kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (the corpus for K1, block 0's ids
   into both tables for K2-K4; K3, wherever it is checked, bit for bit
   run against run and against the plain version of its own summation
   order on the raw deltas, bit for bit against the plain version on
   deltas rounded to a grid on which every sum is exact in any order,
   and within a stated bound of the plain version on a CPU copy), and
   time kernel (K3: with its sort, and alone), plain
   version and — where one PyTorch call computes the same function —
   that call, with torch.profiler; the step kernel (here and in phases
   6, 7 and 12: ``step_result``) is also launched twice (the same bits
   required), timed launch by launch (each kernel's name, ms a call
   and share of the wrapper's time; K5 and K7 must show no band pass)
   and with CUDA events, and launched once more after the timed calls
   (the same bits again); the span kernels' shared-memory layouts
   (K4-K7) as the wrappers size them against the kernels'; also K4 and
   K5 with a negative block wider than a thread block, at a small
   width, and every form of
   K2, K3, K15 and K16 (narrow and wide rows, distinct and repeating
   ids) at widths 1, 3, 50 and 128; and K3 in both forms and K14's
   default and sgd arms on tables and deltas full of float32 subnormals,
   bit for bit their plain versions, which flush as the reference does
   (ROADMAP C12);
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
   versions at the first batch's shapes (K11 bit for bit against the CPU
   model of its summation order, ``sparse_lr_forward_ordered``, the same
   bits on two launches, and within a tolerance of its plain version;
   K12 bit for bit against its plain version on the CPU, which sums as the
   reference does, the same bits on two launches, no host sync in the
   call under ``torch.cuda.set_sync_debug_mode("error")``, and its
   settle pass: a written -0 settled to +0 at the next step, a load's
   zeros and subnormals at the step after it; also softmax at
   C=10, L1 and keys repeated within a sample), K20 ``key_sort`` (K12's
   id sort) bit for bit against ``torch.sort(stable=True)`` on the
   batch's keys, all-equal keys, all-dropped keys and a table of
   2^31 - 1 rows,
   then four sparse paths — ``lr_sparse_local`` (``LocalModel``,
   sigmoid, L2, sgd), ``lr_ftrl_local`` (``FTRLModel``),
   ``lr_sparse_ps`` (``PSModel`` over a sparse matrix table, with K2 and
   K3 checked where its server runs them) and ``lr_ftrl_ps`` (two array
   tables) — and ``lr_dense_ps`` (the mnist.config widths: the matmuls in
   full float32, which the phase asserts, and K21 ``dense_lr_forward``
   between them; K21 and the step's other elementwise stages fed the
   card's matmul outputs, bit for bit the same stages on the CPU),
   each 4 warm-up batches and 64 counted (samples/s, every kernel of
   the path launched, finite losses) and profiled (device ms a batch,
   busy share); the tests' small sets trained on the card and on the
   CPU in six model families (losses, correct counts and weights at
   rtol 1e-4 / atol 1e-6); and the CLI
   ``python -m multiverso_tpu_torch.models.logreg.main <config>``, train
   + test on a 20,000-sample libsvm file;
10. the table data plane, as the reference's table benchmark drives it
   (``bench.py`` ``matrix_bandwidth``: 1,000,000 x 50 float32 tables,
   every 10th row dirty, 100,000 a round padded to 131,072 ids): K13
   under each stateful rule and K14 under default (bit for bit on
   grid-rounded deltas) and each stateful rule against their plain
   versions (also with 5% duplicate ids, wrapped and out-of-range ids,
   one row at 4,096 positions and a worker past the state's slots; rtol
   1e-5 / atol 1e-7; the row at 4,096 positions, whose steps of both
   signs cancel, against the plain version on the CPU, which adds in
   position order as K13 and K14 do); K14 under default and sgd also on
   RAW deltas with every one of those id lists, bit for bit run against
   run and against its plain form (``rows.row_scatter_add_ordered``
   then ``rows.row_gather_plain``: K3's summation order, ROADMAP C11),
   and in its one-writer form on ascending ids; K2 and K3 at C=50, each
   timed on
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
   dcasgd on a pipelined table; K13 and K14 under each stateful rule
   bit for bit against their plain versions on the CPU (20,000 ids of a
   100,000 x 50 table: the kernels fuse products as the reference's XLA
   does, ROADMAP C13, ``tbl_exact_stateful``), beside the tolerance
   check above; finally the tests' small op sequence
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
   to four), timed beside ``x.mean(0)`` / ``torch.sum(x, 0)`` (the mean
   form and ``x.mean(0)`` five times each, in turn, medians); 1 warm-up
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
   memory): the two modes apply the same average at the same point, so
   each rank's final tables must be bit-identical between sync and
   overlap and between the two sync runs (K3 is deterministic);
13. the BSP sync server (``-sync``): ``ps_bsp2``, the main path on two
   workers of one server, ``LocalCluster(2, argv=["-sync=true",
   "-metrics_interval_s=0.5"], roles=["all", "worker"])``, both workers
   on the same corpus with the same seeds (K1, K2, K4 and K3 against
   their plain versions as in phase 3; 8 blocks a worker counted, every
   kernel launched, words/s of both workers, then profiled; finite
   tables; the topic corpus through the same cluster on the card and on
   the CPU with the same draws), beside ``ps_async2``, the same run
   without ``-sync``; ``save_checkpoint`` of ``ps_bsp2``'s server
   tables and ``load_checkpoint`` into a fresh zoo, every row of both
   tables bit for bit, and a torn table file refused with nothing
   restored; ``tbl_bsp_default`` and ``tbl_bsp_momentum``: a dense
   1,000,000 x 50 table on two ranks under ``-sync``, 10 rounds in
   which each worker adds every 10th row (offset 5 rows a worker) and
   Gets both workers' rows (K2, and K3 or K13 under momentum, against
   their plain versions at a server shard's shapes and launched; every
   Get bit for bit the same rounds on the CPU and, under the default
   rule, the sum of exactly both workers' adds so far); and backup
   workers: ``-backup_worker_ratio=50``, worker 1 retires
   (``finish_train``) after 3 rounds, worker 0 makes all 10, the table
   holds the sum of every add bit for bit, and the controller's
   ``ClusterMetrics`` counts both ranks' ``SERVER_PROCESS_ADD``;
14. the client cache, prefetch and 1-bit pushes (ROADMAP A6):
   ``tbl_cache``, the reference bench's ``run_client_cache``
   (``bench.py:2052``: a 32,768 x 64 table, Zipf(1.0) Gets of 256
   draws unique'd, a pool of 80 over 3 passes, 64 hot rows added every
   24 Gets with their recovery prefetch, ``-max_get_staleness=24``):
   the uncached and cached arms (Gets/s, hit and row hit rates) and the
   trainer-shaped loop (60 steps of 2 ms, a Get's stall without and
   with prefetch), K2 and K3 against their plain versions at its
   server's shapes and launched in the cached stream, every Get the
   same bytes in both arms, and the cached arm replayed with each
   prefetch waited on the card and on the CPU: every Get and the hit,
   miss, join and prefetch counts the same; ``hb_ps_host_sgns``,
   ``PSWord2Vec``'s host-buffer arm at phase 8's ``hb_ps_sgns``
   settings with ``-max_get_staleness=8`` and prefetch on (K2 as its
   server gathers the real rows, K9, K3 into the delta buffers and as
   its server adds the host deltas; 2 warm-up and 4 counted batches,
   profiled; a Get's stall a batch without and with prefetch) and
   ``hb_ps_host_1bit``, the same with ``-one_bit_push=true`` (the first
   push's blobs and residual the CPU's encode and the rows after it the
   plain K3's add of the CPU's decode, bit for bit; the encode's host
   ms a batch; the process's peak RSS); then the topic corpus on the
   host-buffer arm, cache off: its tables the device arm's bit for bit
   on the card and on the CPU, and card against CPU.

Phases 1-6 are as the second slice left them, the small-input checks
now also comparing example counts, and K2 and K3 timed over all the
calls of a step (both tables) instead of the output table's alone. One
Huffman tree of the bench dictionary serves every HS model of the run.

Prints one JSON ``kernels`` line (one entry a path and kernel: ``ps``,
``local_<mode>``, ``ps_<mode>``, ``hb_local_<mode>``, ``hb_ps_<mode>``,
``lr_<path>``, ``tbl_<path>``, ``ps_<n>srv[_seg]``, ``ma_mesh4``,
``ma_sgd4``, ``ps_bsp2``, ``tbl_bsp_<rule>``, ``tbl_cache`` or
``hb_ps_host_<sgns|1bit>``, with that path's launches), the card's name and
power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero with
no result when CUDA is not available or the package is missing.

Usage: ``python3 chip_smoke.py`` (one card). ``--profile DIR`` adds a
``torch.profiler`` trace of 8 more blocks (Chrome trace in DIR, the
device's busy share and the host monitors) and keeps the Chrome trace
of every counted path. ``--multiserver-only`` builds the kernels and
runs phase 11 alone (its ``kernels`` line and the card's line, no
result line), ``--ma-only`` phase 12, ``--bsp-only`` phase 13,
``--cache-only`` phase 14 and ``--logreg-only`` phase 9 alike; ``--step-kernels-only [NAMES]``
holds and times the word2vec step kernels K4-K8 alone at every path's
shape (``step_result``; K8 also in its in-place form and the PS
per-pair block step), K12 with K20 at ``lr_sparse_local``'s and K19
in both forms at ``ma_mesh4``'s, each launch by launch (no counted
runs, no result line; NAMES keeps the kernels named, e.g.
``pair_offset_grad,sparse_lr_apply``; ``key_sort`` is K20 alone;
``rows_apply_gather`` phase 10a's table kernel checks;
``pairlist_ns_grad`` K9's forms beside the host-batch paths'; these,
``mesh_allreduce`` and ``sparse_lr_apply`` build no corpus).
``--cpu-rehearsal`` runs
phases 2 and 4-14 at a tiny size
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
import shutil
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
# The word2vec step kernels' plain versions take milliseconds a call and
# launch thousands of small kernels (K4's forms XLA's summation order,
# ROADMAP C2): 3 traced calls time them (20 would trace ~10^5 launches).
PLAIN_REPS = 3
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


def log_ftz(library: str) -> None:
    """The float32 adds, multiplies, fused multiply-adds and special
    functions of the built library's SASS, and how many of them flush
    subnormals (``.FTZ``, from ``-ftz=true``; ROADMAP C12)."""
    import re
    from multiverso_tpu_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    try:
        out = subprocess.run([tool, "-sass", library], capture_output=True,
                             text=True, timeout=300).stdout
    except (OSError, subprocess.TimeoutExpired) as exc:
        log(f"[build] cuobjdump failed: {exc}")
        return
    counts = {}
    for op, suffix in re.findall(r"\b(FADD|FMUL|FFMA|MUFU)(\.[A-Z0-9.]*)?",
                                 out):
        total, ftz = counts.get(op, (0, 0))
        counts[op] = (total + 1, ftz + (".FTZ" in suffix))
    log("[build] SASS float ops (all / .FTZ): " + ", ".join(
        f"{op} {t} / {f}" for op, (t, f) in sorted(counts.items())))
    log_load_pipeline(out, "mesh_reduce_cu")


def log_load_pipeline(sass: str, needle: str) -> None:
    """For each kernel of ``sass`` whose name holds ``needle`` (K19's):
    the most 128-bit global loads it issues between two float adds (the
    loads a thread has in flight before it adds), and the forms of its
    global loads and stores (``.EF``: evict first, the streaming hint;
    ``.CONSTANT``: the read-only path)."""
    import re
    for name, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)",
                                 sass, re.S):
        if needle not in name:
            continue
        ops = re.findall(r"\b(LDG\.[A-Z0-9.]+|STG\.[A-Z0-9.]+|FADD)", body)
        run = most = 0
        for op in ops:
            if op == "FADD":
                run = 0
            elif op.startswith("LDG") and ".128" in op:
                run += 1
                most = max(most, run)
        forms = sorted({op for op in ops if op != "FADD"})
        log(f"[build] {name[-48:]}: at most {most} 128-bit loads between "
            f"two float adds; {', '.join(forms)}")


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
    # (seen once in ~70 sessions of one run); trace such a call again,
    # and after three such sessions time it with CUDA events.
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
    return untraced_ms(torch, fn, reps, only)


def time_split(torch, fn, reps: int = REPS):
    """Device time of one ``fn()`` call kernel by kernel: [(kernel name,
    ms a call)] from one ``torch.profiler`` trace of ``reps`` calls after
    warm-up, largest first (a wrapper that launches several kernels,
    torch's own among them, shows each). ``fn`` may be a list of calls,
    made in turn, as for ``time_ms``."""
    import torch.profiler as tp
    if isinstance(fn, list):
        turn = itertools.cycle(fn)

        def fn():
            return next(turn)()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.key_averages()
                  if float(getattr(evt, "self_device_time_total", 0.0)) > 0]
        short = [f"{evt.key[:40]} x{evt.count}" for evt in events
                 if evt.count % reps]
        if short:
            log(f"[time] launches not a multiple of the {reps} calls "
                f"traced (events lost?): {short}")
        split = sorted([(evt.key, float(evt.self_device_time_total)
                         / reps / 1e3) for evt in events],
                       key=lambda s: -s[1])
        if split:
            return split
        log(f"[time] the profiler recorded no device time (trace "
            f"{attempt + 1} of 3)")
    return [("whole call, untraced", untraced_ms(torch, fn, reps))]


def untraced_ms(torch, fn, reps: int, only: str = "") -> float:
    """``time_queued_ms`` of ``fn`` where three profiler sessions in a
    row recorded nothing (seen in two whole runs): the whole call, its
    launch gaps counted, logged as such."""
    ms = time_queued_ms(torch, fn, reps)
    log(f"[time] {ms:.4f} ms a call from queued CUDA events instead, the "
        f"whole call" + (f", not only the {only!r} kernels" if only else ""))
    return ms


def log_split(name: str, path: str, split) -> str:
    """Log a wrapper's launch-by-launch split; return it as one string."""
    total = sum(ms for _, ms in split)
    text = "; ".join(f"{key[:60]} {ms:.4f} ms ({ms / total:.0%})"
                     for key, ms in split)
    log(f"[split {name} @ {path}] {total:.4f} ms a call: {text}")
    return text


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
    again = subsample.subsample_compact(corpus.flat, corpus.sent,
                                        corpus.keep, u)
    ref = subsample.subsample_compact_plain(corpus.flat, corpus.sent,
                                            corpus.keep, u)
    err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
              for g, r in zip(got, ref))
    twice = all(bool(torch.equal(g, a)) for g, a in zip(got, again))
    dropped = T - int(ref[2])
    log(f"[K1] {T} tokens, {dropped} dropped, {subsample.tiles_of(T)} tiles "
        f"of {subsample.TILE}: bit-exact {'yes' if err == 0 else 'NO'}, "
        f"same bits on two launches {'yes' if twice else 'NO'}; bytes "
        f"moved {T * 20 + dropped * 12 + V * 4} (bound {T * 20 + V * 4})")

    def library_partition():
        mask = u < corpus.keep[corpus.flat.to(torch.int64)]
        order = torch.cat([torch.nonzero(mask).reshape(-1),
                           torch.nonzero(~mask).reshape(-1)])
        return corpus.flat[order], corpus.sent[order]

    log_split("subsample_compact", "ps", time_split(
        torch, lambda: subsample.subsample_compact(corpus.flat, corpus.sent,
                                                   corpus.keep, u)))
    return dict(
        name="subsample_compact",
        tol="bit-exact; same bits on two launches "
            f"{'yes' if twice else 'NO'}", max_abs_err=float(err),
        ok=err == 0 and twice,
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


def scatter_cpu_err(torch, table, ids, delta, got):
    """K3's result ``got`` against the plain version run on a CPU copy of
    the rows ``ids`` reach (``table`` as it was before): (max abs error,
    whether every element is within ``2 L 2^-24 (|x0| + sum |delta|)``,
    L the row's occurrences — twice the first-order bound of a float32
    sum of L + 1 terms in any order, the kernel's tree of sequential
    sums and the plain version's sequential sum alike)."""
    from multiverso_tpu_torch.kernels import rows
    k = delta.shape[0]
    flat, ok = rows._wrapped(ids.reshape(-1)[:k], table.shape[0])
    uniq, inv, counts = torch.unique(flat[ok], return_inverse=True,
                                     return_counts=True)
    if uniq.numel() == 0:
        return 0.0, True
    local = torch.full_like(flat, uniq.numel())
    local[ok] = inv
    sub = table[uniq].cpu()
    want = sub.clone()
    rows.row_scatter_add_plain(want, local.to(torch.int32).cpu(),
                               delta.cpu())
    d = delta.shape[1]
    mass = sub[:, :d].abs().double()
    mass.index_add_(0, inv.cpu(), delta[ok].abs().double().cpu())
    limit = 2.0 * counts.cpu().double()[:, None] * 2.0 ** -24 * mass
    diff = (got[uniq].cpu()[:, :d] - want[:, :d]).abs()
    return float(diff.max()), bool((diff.double() <= limit).all())


def host_call_ms(torch, fn, reps: int = 50) -> float:
    """Host ms of one ``fn()`` call: ``reps`` calls back to back on the
    host clock, without waiting for the card (the launches queue), after
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def check_scatter(torch, cases, D: int, row_bytes: int = 0, rotate=(),
                  distinct: bool = False):
    """K3 on ``cases``, the step's (table, ids, delta) triples, as the
    path launches it (``distinct``: the one-writer form for ids known to
    ascend; else the sorted form): bit for bit two launches on the raw
    deltas against each other and against the kernel-order plain
    version (``row_scatter_add_ordered``; for distinct ids the plain
    version on the card), bit for bit against the plain version on
    deltas rounded ``on_grid`` (every sum exact in any order), and
    within ``scatter_cpu_err``'s bound of the plain version on a CPU
    copy; duplicate ids and the Zipf head included. Timed over all the
    triples, as the step launches them (``rotate``: as in
    ``check_gather``), the sort included, and the kernel alone, and the
    wrapper's host ms a call (its id preparation launches from Python). The
    bound counts the ids and rows of the delta, and each table row they
    reach read and written at ``row_bytes`` (default ``D * 4``; 32 for
    rows narrower than a sector)."""
    from multiverso_tpu_torch.kernels import rows
    err, cpu_err, nonzero, n_bytes = 0.0, 0.0, [], 0
    ok, longest = True, 0
    for table, ids, delta in cases:
        k = delta.shape[0]
        a, b, c = table.clone(), table.clone(), table.clone()
        rows.row_scatter_add(a, ids, delta, 1.0, distinct=distinct)
        rows.row_scatter_add(b, ids, delta, 1.0, distinct=distinct)
        if distinct:
            rows.row_scatter_add_plain(c, ids, delta, 1.0)
        else:
            plan = rows.scatter_plan(ids, k, table.shape[0])
            rows.row_scatter_add_ordered(c, plan, delta, 1.0)
            heads = rows.run_heads(plan.keys).nonzero().reshape(-1)
            lengths = torch.diff(heads, append=heads.new_full((1,), k))
            longest = max(longest, int(lengths.max()))
            del plan
        ok = ok and torch.equal(a, b) and torch.equal(a, c)
        e, within = scatter_cpu_err(torch, table, ids, delta, a)
        cpu_err, ok = max(cpu_err, e), ok and within
        del a, b, c
        base, grid_delta = on_grid(torch, table, ids, delta)
        nonzero.append(float((grid_delta != 0).float().mean()))
        a = base.clone()
        rows.row_scatter_add(a, ids, grid_delta, 1.0, distinct=distinct)
        rows.row_scatter_add_plain(base, ids, grid_delta, 1.0)
        err = max(err, float((a - base).abs().max()))
        del a, base
        reached = touched_rows(torch, ids.reshape(-1)[:k], table.shape[0])
        n_bytes += k * 4 + k * D * 4 + 2 * reached * (row_bytes or D * 4)
    clones = {}
    sets = [[(clones.setdefault(id(table), table.clone()), ids,
              ids.reshape(-1)[:delta.shape[0]].to(torch.int64), delta)
             for table, ids, delta in s] for s in [cases, *rotate]]

    def kernel(t, ids, _, d):
        rows.row_scatter_add(t, ids, d, 1.0, distinct=distinct)

    form = "distinct ids, one writer an element" if distinct else \
        f"sorted, longest run {longest}"
    result = dict(
        name="row_scatter_add",
        tol=f"{form}: bit-exact run to run and vs the kernel-order plain "
            f"version on raw deltas, bit-exact vs the plain version on "
            f"grid-rounded deltas ({[round(x, 3) for x in nonzero]} of them "
            f"nonzero; max err {err:g}); vs the plain version on a CPU "
            f"copy |err| <= 2 L 2^-24 (|x0| + sum |delta|)",
        max_abs_err=cpu_err, ok=ok and err == 0.0,
        source="multiverso_tpu_torch/csrc/row_scatter_add.cu",
        replaces="multiverso_tpu/updater/rules.py:94",
        ms=time_ms(torch, in_turn(sets, kernel)),
        kernel_ms=time_ms(torch, in_turn(sets, kernel), only="scatter_"),
        host_ms=host_call_ms(torch, lambda: kernel(*sets[0][0])),
        plain_ms=time_ms(torch, in_turn(
            sets, lambda t, ids, _, d: rows.row_scatter_add_plain(
                t, ids, d, 1.0))),
        library_ms=time_ms(torch, in_turn(
            sets, lambda t, _, ids64, d: t.narrow(1, 0, d.shape[1])
            .index_add_(0, ids64, d))),
        bound=bound(n_bytes))
    del sets, clones
    return result


def check_row_forms(torch, device) -> None:
    """Every form of K2, K3, K15 and K16 at widths 1, 3, 50 and 128 on
    Zipf ids (a run of 3,000 positions, ids past the table, wrapped
    negatives, the pad sentinel, fewer delta rows than ids), both signs:
    bit for bit the gathers against their plain versions, the scatters
    run against run and against the kernel-order plain version (distinct
    ids: the plain version) on raw deltas and against the plain version
    on grid-rounded deltas. Fatal on any difference."""
    import numpy as np
    from multiverso_tpu_torch.kernels import rows
    rng = np.random.default_rng(12)
    R, n = 50_000, 20_000
    zipf = np.minimum(rng.zipf(1.2, n) - 1, R + 99).astype(np.int32)
    zipf[:3000] = 7
    zipf[3000:3100] = -rng.integers(1, R + 1, 100)
    zipf[3100:3200] = R
    rng.shuffle(zipf)
    ids = torch.from_numpy(zipf).to(device)
    ascending = torch.from_numpy(np.concatenate([
        np.sort(rng.choice(R, n // 2, replace=False)),
        np.full(n // 2, R)]).astype(np.int32)).to(device)
    bad = []
    for width in (1, 3, 50, 128):
        gen = torch.Generator(device=device)
        gen.manual_seed(width)
        table = torch.randn((R, width + 2), generator=gen, device=device)
        delta = torch.randn((n - 5, width), generator=gen, device=device)
        for name, got, want in (
                ("K2 zipf", rows.row_gather(table, ids, width),
                 rows.row_gather_plain(table, ids, width)),
                ("K2 ascending", rows.row_gather(table, ascending, width),
                 rows.row_gather_plain(table, ascending, width)),
                ("K15 window", rows.row_gather_bounded(
                    table, ids, 1000, R - 2000, width),
                 rows.row_gather_bounded_plain(table, ids, 1000, R - 2000,
                                               width))):
            if not torch.equal(got, want):
                bad.append(f"{name} width {width}")
        for sign in (1.0, -1.0):
            for name, cut, distinct in (("K3 sorted", ids, False),
                                        ("K3 distinct", ascending, True)):
                a, b, c = table.clone(), table.clone(), table.clone()
                rows.row_scatter_add(a, cut, delta, sign, distinct=distinct)
                rows.row_scatter_add(b, cut, delta, sign, distinct=distinct)
                if distinct:
                    rows.row_scatter_add_plain(c, cut, delta, sign)
                else:
                    rows.row_scatter_add_ordered(
                        c, rows.scatter_plan(cut, n - 5, R), delta, sign)
                base, grid = on_grid(torch, table, cut, delta)
                g = base.clone()
                rows.row_scatter_add(g, cut, grid, sign, distinct=distinct)
                rows.row_scatter_add_plain(base, cut, grid, sign)
                if not (torch.equal(a, b) and torch.equal(a, c)
                        and torch.equal(g, base)):
                    bad.append(f"{name} width {width} sign {sign}")
            a, b, c = table.clone(), table.clone(), table.clone()
            for t in (a, b):
                rows.row_scatter_add_bounded(t, ids, delta, 1000, R - 2000,
                                             sign)
            rows.row_scatter_add_ordered(
                c, rows.scatter_plan(ids, n - 5, R, (1000, R - 2000)),
                delta, sign)
            if not (torch.equal(a, b) and torch.equal(a, c)):
                bad.append(f"K16 width {width} sign {sign}")
    log(f"[row forms] K2, K3, K15, K16 at widths 1, 3, 50, 128 on {n} "
        f"Zipf ids (a run of 3,000) and {n // 2} ascending ones, both "
        f"signs: {'OK' if not bad else 'FAIL ' + ', '.join(bad)}")
    if bad:
        raise AssertionError(f"row kernels disagree: {bad}")


def subnormal_values(np, rng, shape):
    """Integers in [-40, 40] times 2^-130 (below 16 in magnitude
    subnormal), a fifth normal and ~1e-37, a tenth signed zeros."""
    x = (rng.integers(-40, 41, shape) * 2.0 ** -130).astype(np.float32)
    pick = rng.random(shape)
    x[pick < 0.2] = (rng.standard_normal(int((pick < 0.2).sum()))
                     * 1e-37).astype(np.float32)
    x[(pick >= 0.2) & (pick < 0.25)] = np.float32(-0.0)
    x[(pick >= 0.25) & (pick < 0.3)] = np.float32(0.0)
    return x


def check_subnormals(torch, device) -> None:
    """ROADMAP C12: K3 in both forms and K14's default and sgd arms (the
    sorted form's levels inside its launch, and its one-writer form) on
    tables and deltas full of float32 subnormals, at widths 1, 50 and
    128: bit for bit (int32 views) their plain versions, which flush
    every add's inputs and result as the reference does — the sorted
    forms ``row_scatter_add_ordered`` (then ``row_gather_plain`` for
    K14), the one-writer forms ``row_scatter_add_plain``. Zipf ids with
    runs longer than a task (32). Fatal on any difference."""
    import numpy as np
    from multiverso_tpu_torch.kernels import rows, rules
    rng = np.random.default_rng(23)
    R, n = 4096, 6000
    ids = np.minimum(rng.zipf(1.3, n) - 1, R + 9).astype(np.int32)
    ids[:200] = 3
    rng.shuffle(ids)
    ids = torch.from_numpy(ids).to(device)
    ascending = torch.from_numpy(np.sort(rng.choice(
        R, n // 2, replace=False)).astype(np.int32)).to(device)
    gets = torch.from_numpy(rng.integers(0, R + 5, 512).astype(
        np.int32)).to(device)
    hyp = np.array([0.9, 0.01, 0.1, 0.1], np.float32)

    def bits(x):
        return x.contiguous().view(torch.int32)

    bad, flushed = [], 0
    for width in (1, 50, 128):
        table = torch.from_numpy(subnormal_values(np, rng, (R, width + 2))
                                 ).to(device)
        delta = torch.from_numpy(subnormal_values(np, rng, (n, width))
                                 ).to(device)
        for sign, rule in ((1.0, "default"), (-1.0, "sgd")):
            for name, cut, distinct in (("sorted", ids, False),
                                        ("one writer", ascending, True)):
                k = min(cut.numel(), n)
                d = delta[:k]
                a, c = table.clone(), table.clone()
                rows.row_scatter_add(a, cut, d, sign, distinct=distinct)
                if distinct:
                    rows.row_scatter_add_plain(c, cut, d, sign)
                else:
                    rows.row_scatter_add_ordered(
                        c, rows.scatter_plan(cut, k, R), d, sign)
                if not torch.equal(bits(a), bits(c)):
                    bad.append(f"K3 {name} width {width} sign {sign}")
                small = (table != 0) & (table.abs() < 2.0 ** -126)
                flushed += int((small & (a == 0)).sum())
                f = table.clone()
                got = rules.rows_apply_gather(rule, f, None, cut, d, hyp, 0,
                                              gets, width, distinct=distinct)
                want = rows.row_gather_plain(c, gets, width)
                if not (torch.equal(bits(f), bits(c))
                        and torch.equal(bits(got), bits(want))):
                    bad.append(f"K14 {rule} {name} width {width}")
    log(f"[subnormals] K3 (sorted, one writer) and K14 default/sgd at widths "
        f"1, 50, 128 on subnormal tables and deltas: "
        f"{'OK' if not bad else 'FAIL ' + ', '.join(bad)} ({flushed} "
        f"subnormal table elements flushed to zero)")
    if bad:
        raise AssertionError(f"subnormals: kernels disagree with their "
                             f"plain versions: {bad}")


def report(results, card: str, path: str):
    """Log the checks of ``path``'s kernels; fail on any disagreement."""
    for r in results:
        r["path"] = path
        lib = "n/a" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        alone = f" total ({r['kernel_ms']:.4f} kernel alone; host " \
            f"{r['host_ms']:.4f} ms a call)" if "kernel_ms" in r else ""
        log(f"[kernel {r['name']} @ {path}] {card} | max_abs_err "
            f"{r['max_abs_err']:g} ({r['tol']}) "
            f"{'OK' if r['ok'] else 'FAIL'} | kernel {r['ms']:.4f} ms"
            f"{alone} | plain {r['plain_ms']:.4f} ms | library {lib} | bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{path}: kernels disagree with their plain "
                             f"versions: {bad}")
    return results


def check_span_layouts(D: int) -> None:
    """The span kernels' shared-memory layouts as the wrappers size them
    (``hs.span_smem``, ``sgns.span_smem``, ``cbow.span_smem``,
    ``hs.cbow_span_smem``) against the kernels' own (``mv_hs_span_smem``,
    ``mv_banded_sgns_smem``, ``mv_banded_cbow_smem``,
    ``mv_hs_cbow_smem``), at the spans the word2vec paths take."""
    from multiverso_tpu_torch.kernels import build, cbow, hs, sgns
    lib = build.library()
    W, K, L = WINDOW, NEG, 22
    for C in (8192, 32768):
        S, warps = hs.span_geometry(C, W, D, L, 132)
        if hs.span_smem(S, W, D, L, warps) != lib.mv_hs_span_smem(
                S, W, D, L, warps):
            raise AssertionError(f"K6 span layout differs at S={S}")
        S = hs.cbow_span_geometry(C, W, D, 132)
        if hs.cbow_span_smem(S, W, D) != lib.mv_hs_cbow_smem(S, W, D):
            raise AssertionError(f"K7 span layout differs at S={S}")
    for C in (16384, 32768):
        S, warps = sgns.span_geometry(C, W, K, NEG_BLOCK, D)
        if sgns.span_smem(S, W, K, NEG_BLOCK, D, warps) != \
                lib.mv_banded_sgns_smem(S, W, K, NEG_BLOCK, D, warps):
            raise AssertionError(f"K4 span layout differs at S={S}")
    for C, B, d in ((16384, NEG_BLOCK, D), (32768, NEG_BLOCK, D),
                    (2048, 512, 16), (24, 1, 3)):
        S = cbow.span_geometry(C, W, K, B, d)
        if cbow.span_smem(S, W, K, B, d) != lib.mv_banded_cbow_smem(
                S, W, K, B, d):
            raise AssertionError(f"K5 span layout differs at S={S}, B={B}")
    log("[kernel layouts] K4-K7 shared memory: the wrappers' sizes match "
        "the kernels'")


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
    timed (``ps_kernel_checks``), then the kernels' other forms."""
    results = ps_kernel_checks(torch, trainer)
    check_span_layouts(trainer.config.embedding_size)
    check_wide_blocks(torch, trainer.device)
    check_row_forms(torch, trainer.device)
    check_subnormals(torch, trainer.device)
    return report(results, card, "ps")


def ps_kernel_checks(torch, trainer, path: str = "ps"):
    """K1 on the corpus, K2 and K3 into both tables at block 0's ids and
    K4 at block 0's call of a PS SGNS trainer, each against its plain
    version and timed."""
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
    nb = C // B
    flops = 2 * D * (C * 2 * W + C * K) * 2 + 2 * D * C * 2 * W \
        + 2 * D * nb * K * B
    results.append(step_result(
        torch, sgns.banded_sgns_grad, sgns.banded_sgns_grad_plain,
        (v, urows, pmask, W, K, B, -0.025),
        (C * D + urows.numel() + C * 2 * W) * 4
        + (C * D + urows.numel()) * 4 + 8, flops, "banded_sgns_grad",
        "multiverso_tpu_torch/csrc/banded_sgns.cu",
        "multiverso_tpu/models/wordembedding/device_train.py:729", path))
    del v, urows, table_in, table_out
    return results


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


def same_bits(torch, a, b) -> bool:
    """Whether two step-kernel results ((d_in, d_out, loss, count)) are
    the same bits."""
    return all(torch.equal(x.reshape(-1).view(torch.int32),
                           y.reshape(-1).view(torch.int32))
               for x, y in zip(a, b))


def step_result(torch, kernel, plain, args, n_bytes: float, flops: float,
                name: str, source: str, replaces: str, path: str):
    """A word2vec step kernel (K4-K8) on ``args`` against its plain
    version (``compare_step``), launched twice (the same bits required:
    no atomics), timed beside its bound and split launch by launch."""
    got = kernel(*args)
    again = kernel(*args)
    bits = same_bits(torch, got, again)
    ref = plain(*args)
    err, ok, loss_rel = compare_step(got, ref)
    del again, ref
    split = time_split(torch, lambda: kernel(*args))
    log_split(name, path, split)
    # CUDA events over REPS calls (the wrappers' launches included), and
    # the same bits again after every timed call.
    events_ms = time_events_ms(torch, lambda: kernel(*args))
    bits = bits and same_bits(torch, got, kernel(*args))
    log(f"[kernel {name} @ {path}] CUDA events: {events_ms:.4f} ms a call "
        f"(launches included); the same bits after the timed calls: "
        f"{'yes' if bits else 'NO'}")
    extra = ""
    if name in ("banded_cbow_grad", "hs_cbow_grad"):
        # One span kernel and the one-warp sum of its partials: the band
        # pass of the earlier form must not show.
        single = not any("band_pass" in key for key, _ in split)
        bits = bits and single
        extra = f"; no band_pass launch: {'yes' if single else 'NO'}"
    if name == "pair_offset_grad":
        inplace = check_pair_inplace(torch, args, got, path)
        bits = bits and inplace
        extra = f"; in-place form = delta form + three adds, bit for " \
            f"bit: {'yes' if inplace else 'NO'}"
    result = dict(
        name=name, tol=f"grads |err| <= 1e-5 + 1e-4 |plain|; loss rel err "
        f"{loss_rel:.2g} <= 1e-5; counts equal; same bits on two launches "
        f"{'yes' if bits else 'NO'}{extra}", max_abs_err=err,
        ok=ok and bits,
        source=source, replaces=replaces,
        ms=sum(ms for _, ms in split),
        plain_ms=time_ms(torch, lambda: plain(*args), PLAIN_REPS),
        library_ms=None,
        bound=bound(n_bytes, flops))
    log(f"[kernel {name} @ {path}] bound from {n_bytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP")
    return result


def check_pair_inplace(torch, args, got, path: str) -> bool:
    """K8's in-place form (the PS path's) on copies of ``args``' rows
    against the delta form ``got`` added with torch's three ``+=``: the
    same bits. Times the in-place form launch by launch."""
    from multiverso_tpu_torch.kernels import pair
    v, u, m, K, scale = args
    C = v.shape[0]
    vv, uu = v.clone(), u.clone()
    loss, examples = pair.pair_offset_grad_(vv, uu[:C], uu[C:], m, K, scale)
    want_v, want_u = v.clone(), u.clone()
    want_v += got[0]
    want_u[:C] += got[1][:C]
    want_u[C:] += got[1][C:]
    ok = same_bits(torch, (vv, uu, loss, examples),
                   (want_v, want_u, got[2], got[3]))
    log_split("pair_offset_grad in place", path, time_split(
        torch, lambda: pair.pair_offset_grad_(vv, uu[:C], uu[C:], m, K,
                                              scale)))
    return ok


def ps_pair_block_step(torch, trainer, table_in, table_out, path: str):
    """The per-pair mode's PS block step (``device_train._block_ids``'s
    ``step``: 2W K8 sub-steps on local copies of block 0's pulled rows,
    then the push deltas), timed launch by launch: the device ms of a
    block and of a sub-step (the block over 2W)."""
    from multiverso_tpu_torch.kernels import rows
    from multiverso_tpu_torch.models.wordembedding import device_train
    C, W = trainer._C, trainer.config.window
    D = trainer.config.embedding_size
    u = trainer._draws.epoch_uniforms(1234, trainer._corpus.n_tokens)
    kept, ksent, n_kept = trainer._corpus.prep_epoch(u)
    kept_pad, ksent_pad = device_train._pad_stream(C, W, kept, ksent)
    draws = device_train.TorchDraws(trainer.device).group_draws(
        1234, 0, 1, C, W, trainer._neg_shape(), trainer._vocab)
    in_ids, out_ids, step = device_train._block_ids(
        trainer.config, trainer._tables, C, trainer._B, trainer._per_pair,
        draws[0], kept_pad, ksent_pad, int(n_kept), 0, 0.025, 1.0)
    v = rows.row_gather(table_in, in_ids, D)
    u_rows = rows.row_gather(table_out, out_ids, D)
    split = time_split(torch, lambda: step(v, u_rows))
    log_split("ps per-pair block step", path, split)
    total = sum(ms for _, ms in split)
    log(f"[{path}] the PS per-pair block step: {total:.4f} device ms a "
        f"block, {total / (2 * W):.4f} a sub-step (2W = {2 * W})")


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
    log(f"[kernel {name} @ {path}] C={trainer._C}")
    results.append(step_result(torch, kernel, plain, args, n_bytes, flops,
                               name, source, replaces, path))
    results.append(check_scatter(torch, scatters, D))
    del table_in, table_out, got, args, scatters
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


def check_k9_forms(torch, device):
    """K9's forms beside the path's (float4 columns, K <= 8): 4,096 pairs
    in blocks of 8 over random tables, skip-gram and CBOW (2W = 10, some
    window slots masked, some pairs masked), in the register form at D =
    128 and K = 5 and 8 (its two negative counts), D = 50 (two float
    columns a lane), D = 101 and 70 (four float columns a lane, K 5 and
    7), and in the general form at D = 300 (wider than the register form
    holds) and K = 12 (more negatives than it holds), each against the
    plain version at phase 8's tolerance. Returns (ok, text)."""
    from multiverso_tpu_torch.kernels import pairlist
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    B, nb, rows = 4096, 8, 5000
    bad, cases = [], 0
    shapes = ((128, 5), (128, 8), (50, 5), (101, 5), (70, 7), (300, 5),
              (128, 12))
    for D, K in shapes:
        ein = torch.randn((rows, D), generator=gen, device=device) * 0.1
        eout = torch.randn((rows, D), generator=gen, device=device) * 0.1
        tgt = torch.randint(0, rows, (B,), generator=gen, device=device,
                            dtype=torch.int32)
        neg = torch.randint(0, rows, (B // nb, K), generator=gen,
                            device=device, dtype=torch.int32)
        pm = (torch.rand(B, generator=gen, device=device) > 0.1).float()
        for cbow in (False, True):
            if cbow:
                in_idx = torch.randint(0, rows, (B, 10), generator=gen,
                                       device=device, dtype=torch.int32)
                wm = (torch.rand((B, 10), generator=gen, device=device)
                      > 0.2).float()
            else:
                in_idx = torch.randint(0, rows, (B,), generator=gen,
                                       device=device, dtype=torch.int32)
                wm = None
            args = (ein, eout, in_idx, wm, tgt, neg, pm, -0.025)
            err, ok, _ = compare_step(pairlist.pairlist_ns_grad(*args),
                                      pairlist.pairlist_ns_grad_plain(*args))
            cases += 1
            if not ok:
                bad.append(f"D={D} K={K} {'cbow' if cbow else 'sg'} "
                           f"({err:g})")
    return not bad, (f"other forms ({cases} calls: (D, K) "
                     f"{', '.join(map(str, shapes))}, skip-gram and CBOW) "
                     f"within the tolerance: "
                     + ("yes" if not bad else f"NO ({'; '.join(bad)})"))


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
    if device.type == "cuda":
        forms_ok, forms_text = check_k9_forms(torch, device)
        log(f"[kernel pairlist_ns_grad] {forms_text}")
        first = next(r for r in results if r["name"] == "pairlist_ns_grad")
        first.update(ok=first["ok"] and forms_ok,
                     tol=f"{first['tol']}; {forms_text}")
        if not forms_ok:
            raise AssertionError(f"pairlist_ns_grad: {forms_text}")
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
LR_CLI_SAMPLES = 20_000  # the CLI's file: small, for the script's time limit
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
    push — the delta rows, or FTRL's dense push buffers): K11 bit for
    bit against ``sparse_lr_forward_ordered`` on the CPU, the same bits
    on two launches, and within |err| <= 1e-5 + 1e-4 |plain| (pred,
    diff), loss sum rel err <= 1e-5 and equal hit counts of its plain
    version; K12 bit-exact against its plain version on the
    CPU (which adds a row's terms from its regularization term in
    position order, as K12 and the reference do; ROADMAP C13: on the
    card the plain version's ``index_add_`` takes another order each
    run), the same bits on two launches, and K12's settle pass
    (``lr_settle_check``). ``dup`` repeats keys within samples (a quarter
    of the samples name their first categorical key twice more). Returns
    the two kernels' result entries (timed when ``time_it``)."""
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
    # K11's own order (lanes a sample, then their xor tree) on the CPU.
    cpu = torch.device("cpu")
    ordered = lrk.sparse_lr_forward_ordered(
        table.to(cpu) if ftrl is None else tuple(t.to(cpu) for t in table),
        keys.to(cpu), values.to(cpu), labels.to(cpu), weights.to(cpu), act,
        ftrl)
    again = lrk.sparse_lr_forward(table, keys, values, labels, weights,
                                  act, ftrl)
    exact = same_bits(torch, [g.cpu() for g in got], ordered)
    fwd_twice = same_bits(torch, got, again)
    ok = ok and exact and fwd_twice
    sectors = -(-C * 4 // 32) * 32     # bytes of a table row's sectors
    tables = 1 if ftrl is None else 2
    gathered = int(torch.unique(lrk.gather_ids(keys, R)).numel())
    fwd_bytes = B * K * 4 * 2 + B * 4 * 2 + gathered * sectors * tables \
        + B * C * 4 * 2 + B * 4 * 2
    fwd = dict(
        name="sparse_lr_forward", ok=ok, max_abs_err=err,
        tol=f"bit-exact against its order's CPU model "
            f"({lrk.forward_lanes(K, C)} lanes a sample): "
            f"{'yes' if exact else 'NO'}; same bits on two launches "
            f"{'yes' if fwd_twice else 'NO'}; against the plain version "
            f"pred, diff |err| <= 1e-5 + 1e-4 |plain|; loss rel err "
            f"{loss_rel:.2g} <= 1e-5; hits {hits[0]} = {hits[1]}",
        source=_LR_SRC, replaces=_LR_REF + "objective.py:89",
        library_ms=None, bound=bound(fwd_bytes, 2.0 * B * K * C))

    count = torch.full((1,), float(max(int((weights > 0).sum()), 1)),
                       device=device)
    diff = ref[1]
    scale = 0.8

    def push_buffers(dev=device):
        if not (ps and ftrl is not None):
            return None
        return (torch.zeros(R, C, device=dev), torch.zeros(R, C, device=dev))

    a, a2 = _clone_table(table), _clone_table(table)
    b = table.to(cpu) if ftrl is None else tuple(t.to(cpu) for t in table)
    pa, pa2, pb = push_buffers(), push_buffers(), push_buffers(cpu)
    want_rows = ps and ftrl is None

    def apply(t, p):
        return lrk.sparse_lr_apply(
            t, keys, values, diff, count, reg=reg, coef=config.regular_coef,
            scale=scale, ftrl=ftrl, delta_rows=want_rows, push=p)

    synced = no_sync(torch, lambda: apply(a, pa))
    if not synced[1]:
        # The check failed; run the call again to hold its numbers.
        a, pa = _clone_table(table), push_buffers()
        synced = (apply(a, pa), False)
    rows_a, delta_a = synced[0]
    rows_2, delta_2 = apply(a2, pa2)
    touched = lrk.touched_rows(keys.to(cpu), R)
    delta_b, _ = lrk.sparse_lr_apply_plain(
        b, touched, values.to(cpu), diff.to(cpu), count.to(cpu), reg,
        config.regular_coef, scale, ftrl, want_rows, pb)
    U = int(touched.rows.numel())
    pairs = list(zip((a,) if ftrl is None else a, (b,) if ftrl is None
                     else b))
    twice = list(zip((a,) if ftrl is None else a, (a2,) if ftrl is None
                     else a2))
    same_rows = True
    if want_rows:
        pairs.append((delta_a[:U], delta_b))
        twice += [(rows_a, rows_2), (delta_a[:U], delta_2[:U])]
        same_rows = bool(torch.equal(rows_a[:U].cpu(), touched.rows)) \
            and bool((rows_a[U:] == R).all())
    if pa is not None:
        pairs += list(zip(pa, pb))
        twice += list(zip(pa, pa2))
    pairs = [(x.to(cpu), y) for x, y in pairs]
    apply_err = max(float((x - y).abs().max()) for x, y in pairs)
    exact = all(torch.equal(x.contiguous().view(torch.int32),
                            y.contiguous().view(torch.int32))
                for x, y in pairs)
    apply_same = all(torch.equal(x.contiguous().view(torch.int32),
                                 y.contiguous().view(torch.int32))
                     for x, y in twice)
    app_bytes = B * K * 4 * 2 + B * C * 4 + 4 + U * sectors * 2 * tables \
        + (U * C * 4 if want_rows else 0) \
        + (U * sectors * 2 if pa is not None else 0)
    zero_ok, zero_text = lr_settle_check(torch, lrk, device)
    app = dict(
        name="sparse_lr_apply",
        ok=exact and same_rows and apply_same and synced[1] and zero_ok,
        max_abs_err=apply_err,
        tol=f"bit-exact against the plain version on the CPU ({U} touched "
            f"rows, the padding row's {int(touched.counts[-1])} "
            f"positions among them): {'yes' if exact else 'NO'}; same "
            f"bits on two launches {'yes' if apply_same else 'NO'}; no host "
            f"sync in the call {'yes' if synced[1] else 'NO'}; {zero_text}",
        source=_LR_SRC, replaces=_LR_REF + "objective.py:89",
        library_ms=None, bound=bound(app_bytes, 3.0 * B * K * C))
    log(f"[{tag}] K11/K12 case: B={B} K={K} C={C} R={R} "
        f"{'ftrl' if ftrl else 'sgd'} act={act} reg={reg} dup={dup} | "
        f"{gathered} gathered rows, {U} touched | K11 "
        f"{'OK' if fwd['ok'] else 'FAIL'} ({fwd['tol']}) | K12 "
        f"{'OK' if app['ok'] else 'FAIL'} (max err {apply_err:g}; "
        f"{app['tol']})")
    if time_it:
        ta, pa2 = _clone_table(table), push_buffers()
        fwd["ms"] = time_ms(torch, lambda: lrk.sparse_lr_forward(
            table, keys, values, labels, weights, act, ftrl))
        fwd["plain_ms"] = time_ms(torch, lambda: lrk.sparse_lr_forward_plain(
            table, keys, values, labels, weights, act, ftrl))

        def run_kernel():
            return lrk.sparse_lr_apply(
                ta, keys, values, ref[1], count, reg=reg,
                coef=config.regular_coef, scale=scale, ftrl=ftrl,
                delta_rows=want_rows, push=pa2)

        def run_plain():
            return lrk.sparse_lr_apply_plain(
                ta, lrk.touched_rows(keys, R), values, ref[1], count, reg,
                config.regular_coef, scale, ftrl, want_rows, pa2)

        log_split("sparse_lr_apply", tag, time_split(torch, run_kernel))
        # K20's cooperative launch may be lost from a profiler trace:
        # the call's time from queued CUDA events.
        app["ms"] = time_queued_ms(torch, run_kernel)
        app["plain_ms"] = time_ms(torch, run_plain)
        entries = [fwd, app, check_key_sort(torch, keys, R)]
        log(f"[{tag}] K12 {app['ms']:.4f} ms a call with its id sort "
            f"(K20 key_sort, {entries[2]['ms']:.4f} ms alone)")
        return entries
    return [fwd, app]


def lr_settle_check(torch, lrk, device):
    """K12's settle pass (``lr_settle``, ROADMAP C12) against its plain
    version on the CPU, tables and flags bit for bit after each step:
    an L2 sgd step whose update of a weight of -2e-38 underflows
    (written as -0, the flag raised), then a step that does not touch
    that row (its -0 settled to +0), FTRL likewise on ``z``; and one
    step after the host's request (a load) with -0 and subnormals in
    rows it does not touch (settled to +0 under L2, to their sign's zero
    without a regularizer) and in one it touches. Returns (ok, text)."""
    cpu = torch.device("cpu")
    R, B, K = 4096, 8, 4
    keys = torch.arange(B * K, dtype=torch.int32).reshape(B, K) * 7 + 1
    values = torch.full((B, K), 0.25)
    keys[0] = torch.tensor([5, R - 1, R - 1, R - 1])
    values[0] = 0.0
    count = torch.full((1,), 16.0)
    later = keys.clone()
    later[0, 0] = 9

    def steps(ftrl, reg, plus, w, d, request, batches, row):
        tables = [w.clone(), w.clone()] if ftrl is None else \
            [(w.clone(), w.abs()), (w.clone(), w.abs())]
        flags = [lrk.SettleFlag(device, plus), lrk.SettleFlag(cpu, plus)]
        if request:
            for flag in flags:
                flag.request()
        got = []
        for step_keys in batches:
            for side, dev in ((0, device), (1, cpu)):
                t = tables[side]
                t = t.to(dev) if ftrl is None else tuple(x.to(dev) for x in t)
                lrk.sparse_lr_apply(
                    t, step_keys.to(dev), values.to(dev),
                    torch.full((B, 1), d, device=dev), count.to(dev),
                    reg=reg, coef=0.01, scale=0.37, ftrl=ftrl,
                    settle=flags[side])
                tables[side] = t
            one = [x.to(cpu) for x in ((tables[0],) if ftrl is None
                                       else tables[0])]
            two = [x for x in ((tables[1],) if ftrl is None else tables[1])]
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(one, two))
            got.append((int(one[0][row, 0].view(torch.int32)),
                        flags[0].raised(), flags[1].raised(), same))
        return got

    bad = []
    # (FTRL, the value at row 5, diff): the term v * diff / 16 takes
    # w = -2e-38 to -6.1e-39 (sgd, lr 0.37) or z to -1.25e-39 (FTRL).
    for ftrl, v, d in ((None, 1.2e-36, -0.5),
                       (lrk.Ftrl(0.1, 1.0, 0.0, 0.0), 6e-37, 0.5)):
        values[0, 0] = v
        w = torch.linspace(-0.5, 0.5, R)[:, None].contiguous()
        w[5] = -2e-38
        got = steps(ftrl, lrk.REG_L2 if ftrl is None else 0, True, w, d,
                    False, (keys, later), 5)
        if got != [(-2 ** 31, True, True, True), (0, False, False, True)]:
            bad.append(f"{'ftrl' if ftrl else 'sgd'}: {got}")
    values[0, 0] = 0.25
    # A load: untouched rows 2-4 (-0, +/-1e-39), touched row 29 (-1e-39).
    w = torch.linspace(-0.5, 0.5, R)[:, None].contiguous()
    w[2], w[3], w[4], w[29] = -0.0, 1e-39, -1e-39, -1e-39
    for reg, plus in ((lrk.REG_L2, True), (lrk.REG_NONE, False)):
        got = steps(None, reg, plus, w, -0.5, True, (keys,), 4)
        if got != [(0 if plus else -2 ** 31, False, False, True)]:
            bad.append(f"load, {'L2' if plus else 'no reg'}: {got}")
    return not bad, ("settle pass: a written -0 flagged, then settled to "
                     "+0, and a load's zeros and subnormals settled, as "
                     "the plain version: " + ("yes" if not bad else
                                              f"NO ({'; '.join(bad)})"))


def no_sync(torch, fn):
    """(``fn()``, True) with ``torch.cuda.set_sync_debug_mode("error")``
    around the call; (None, False) if the call synchronized with the
    card (torch raises on that)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(), True
    except RuntimeError as exc:
        log(f"[no sync] the call synchronized: {exc}")
        return None, False
    finally:
        torch.cuda.set_sync_debug_mode(0)


def kernel_names(torch, fn, reps: int = REPS):
    """(kernels a call, kernel names) of ``fn()`` from one
    ``torch.profiler`` trace of ``reps`` calls after warm-up (a session
    that records nothing is traced again, as in ``time_ms``). The
    profiler can lose a share of a cooperative kernel's launches (15 of
    20 seen), so a count below one a call is a loss, not a call that
    launched nothing; the times come from ``time_queued_ms``."""
    import torch.profiler as tp
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.key_averages()
                  if float(getattr(evt, "self_device_time_total", 0.0)) > 0]
        count = sum(evt.count for evt in events)
        if count:
            return count / reps, sorted({evt.key[:40] for evt in events})
        log(f"[time] the profiler recorded no device time (trace "
            f"{attempt + 1} of 3)")
    raise RuntimeError("the profiler recorded no device time")


def time_queued_ms(torch, fn, reps: int = REPS) -> float:
    """Device time of one ``fn()`` call, the gaps between its launches
    included: CUDA events around ``reps`` calls that the host queues
    behind a spin kernel (``torch.cuda._sleep``), so the card runs them
    back to back and the host's launch time is hidden. If the spin ended
    before the host had queued every call, it is taken again, longer.
    For calls of tens of microseconds, where ``time_ms``'s profiler may
    lose cooperative launches and events around unqueued calls would
    time the host."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("the host did not queue the calls within the spin")


def check_key_sort(torch, keys, R: int):
    """K20 against its plain version, ``torch.sort(stable=True)`` of the
    wrapped keys, bit for bit (keys and positions) and twice alike: on
    phase 9's keys, all equal, all dropped (every id past either end),
    random ids into a table of 2^31 - 1 rows (31 key bits), one key,
    1,000 keys (one short tile), and 4M keys (2,048 tiles: more than the
    resident blocks, so a block takes several). At phase 9's keys also
    one launch a call (the wrapper's count over ``REPS`` calls, and one
    kernel name and at most one kernel a call in a profiler trace) and
    no host sync. Timed there with ``time_queued_ms``, as are its plain
    version and the library call, ``torch.sort(stable=True)`` of the
    keys already wrapped."""
    from multiverso_tpu_torch.kernels import keysort
    gen = torch.Generator(device=keys.device)
    gen.manual_seed(31)
    big = 2 ** 31 - 1
    dropped = torch.full_like(keys, R + 5)
    dropped[::2] = -R - 3

    def ids(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen,
                             device=keys.device, dtype=torch.int32)
    cases = (("phase 9's keys", keys, R),
             ("all equal", torch.full_like(keys, 7), R),
             ("all dropped", dropped, R),
             ("2^31 - 1 rows", ids(keys.numel(), -2 ** 31, big), big),
             ("1 key", ids(1, -R, R), R),
             ("1,000 keys", ids(1000, -R - 9, R + 9), R),
             ("4M keys", ids(4 << 20, -R - 9, R + 9), R))
    bad = []
    for name, case_ids, rows in cases:
        got = keysort.key_sort(case_ids, rows)
        again = keysort.key_sort(case_ids, rows)
        want = keysort.key_sort_plain(case_ids, rows)
        if not all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(got, again, want)):
            bad.append(name)
    del cases
    n = keys.numel()
    before = keysort.key_sort.launches
    for _ in range(REPS):
        keysort.key_sort(keys, R)
    wrapper = (keysort.key_sort.launches - before) / REPS
    per_call, names = kernel_names(torch, lambda: keysort.key_sort(keys, R))
    want = keysort.KERNELS_A_CALL
    if wrapper != 1 or len(names) != want or per_call > want:
        bad.append(f"{per_call:g} kernels a call traced")
    synced = no_sync(torch, lambda: keysort.key_sort(keys, R))[1]
    if not synced:
        bad.append("a host sync")
    wrapped = keysort.sort_keys(keys, R).to(torch.int32)
    result = dict(
        name="key_sort", ok=not bad, max_abs_err=0.0 if not bad else 1.0,
        tol=f"keys and positions bit for bit vs torch.sort(stable=True) "
            f"and twice alike on phase 9's keys, all equal, all dropped, "
            f"2^31 - 1 rows, 1 key, 1,000 keys, 4M keys; {wrapper:g} "
            f"launch a call, {per_call:g} kernels a call traced "
            f"({', '.join(names)}); no host sync "
            f"{'yes' if synced else 'NO'}"
            f"{'' if not bad else '; FAIL ' + ', '.join(bad)} "
            f"({keysort.key_bits(R)} key bits at R = {R})",
        source=_CSRC + "key_sort.cu",
        replaces=_LR_REF + "objective.py:106",
        ms=time_queued_ms(torch, lambda: keysort.key_sort(keys, R)),
        plain_ms=time_queued_ms(
            torch, lambda: keysort.key_sort_plain(keys, R)),
        library_ms=time_queued_ms(
            torch, lambda: torch.sort(wrapped, stable=True)),
        bound=bound(n * 4 + n * 4 * 2))
    return result


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
            check_scatter(torch, ((table, ids, delta),), 1, row_bytes=32,
                          distinct=True)]


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


def lr_dense_stages(torch, np, model, batch):
    """K21 and the dense step's other elementwise stages (ROADMAP C14) on
    the model's device, fed that device's own matmul outputs, against the
    same stages on the CPU fed those outputs copied over: pred, diff,
    each sample's loss, hits (K21), the gradient, PSModel's delta and
    weights and LocalModel's fused update, bit for bit. Returns K21's
    result entry (timed at the batch's shape)."""
    from multiverso_tpu_torch.kernels import logreg as lrk
    from multiverso_tpu_torch.kernels.flush import flush as f
    from multiverso_tpu_torch.kernels.flush import fma
    from multiverso_tpu_torch.models.logreg import objective
    config, dev = model.config, model.device
    act = objective._act_code(config.objective_type)
    reg = objective._reg_code(config.regular_type)
    lr = objective.learning_rate(config, model.update_count)
    w = model._w.clone()
    x, labels, weights = (torch.from_numpy(a).to(dev) for a in
                          (batch.x, batch.labels, batch.weights))
    logits = objective.dense_matmul(x, w)

    def stages(logits, gsum, w, labels, weights):
        pred, diff, loss, hit = lrk.dense_lr_forward(logits, labels,
                                                     weights, act)
        grad = objective.dense_grad(gsum, objective.dense_count(weights), w,
                                    reg, config.regular_coef)
        rate = torch.tensor(lr, dtype=torch.float32, device=w.device)
        delta = f(grad * rate)
        return (pred, diff, loss, hit, grad, delta, f(f(w) - delta),
                fma(-grad, rate, w))

    diff = lrk.dense_lr_forward(logits, labels, weights, act)[1]
    gsum = objective.dense_matmul(x.T, diff)
    got = stages(logits, gsum, w, labels, weights)
    again = stages(logits, gsum, w, labels, weights)
    cpu = torch.device("cpu")
    want = stages(*(t.to(cpu) for t in (logits, gsum, w, labels, weights)))
    names = ("pred", "diff", "loss", "hit", "grad", "delta", "w", "w fused")
    bad = [n for n, g, r in zip(names, got, want)
           if not torch.equal(g.cpu().reshape(-1).view(torch.int32),
                              r.reshape(-1).view(torch.int32))]
    twice = same_bits(torch, got, again)
    log(f"[lr_dense_ps] elementwise stages on the card (K21 and torch) vs "
        f"the CPU, fed the card's matmul outputs ({tuple(logits.shape)} "
        f"logits, {tuple(gsum.shape)} gradient sums): "
        f"{'bit for bit' if not bad else 'DIFFER in ' + ', '.join(bad)}; "
        f"same bits twice {'yes' if twice else 'NO'}")
    if bad or not twice:
        raise AssertionError(f"lr_dense_ps: stages differ in {bad}")
    err = max(float((g.cpu().float() - r.float()).abs().max())
              for g, r in zip(got[:4], want[:4]))
    B, C = logits.shape
    return dict(
        name="dense_lr_forward", ok=True, max_abs_err=err,
        tol="bit-exact against its plain version on the CPU (pred, diff, "
            "loss, hits), same bits on two launches",
        source=_LR_SRC, replaces=_LR_REF + "objective.py:67",
        library_ms=None, bound=bound(B * C * 4 * 3 + B * 4 * 4),
        ms=time_ms(torch, lambda: lrk.dense_lr_forward(logits, labels,
                                                       weights, act)),
        plain_ms=time_ms(torch, lambda: lrk.dense_lr_forward_plain(
            logits, labels, weights, act)))


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
            need = ["sparse_lr_forward", "sparse_lr_apply", "key_sort"]
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
    if cuda and (torch.backends.cuda.matmul.allow_tf32 or
                 torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("lr_dense_ps: float32 matmuls must run in full "
                             "float32 (TF32 is on)")
    mv.init([], device=None if cuda else "cpu")
    try:
        model = PSModel(Configure(**LR_DENSE))
        server = model._table.zoo.server_tables[model._table.table_id]
        if server._data.device != device:
            raise AssertionError(f"the array table lies on "
                                 f"{server._data.device}")
        counts["lr_dense_ps"] = drive_lr(torch, model, "lr_dense_ps",
                                         ("dense_lr_forward",), card,
                                         workdir, profile_dir, dense, warm)
        if cuda:
            results += report([lr_dense_stages(torch, np, model, dense[0])],
                              card, "lr_dense_ps")
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
    (ids, delta) ``sets`` in turn, worker 0, with CUDA events around
    queued calls (the profiler can lose K20's and K13's launches)."""
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
        ms=queued_in_turn_ms(torch, [
            lambda i=i, d=d: rules.row_rule_apply(rule, a_d, a_s, i, d, hyp,
                                                  0) for i, d in sets]),
        plain_ms=time_ms(torch, in_turn(
            [[s] for s in sets], lambda i, d: rules.row_rule_apply_plain(
                rule, a_d, a_s, i, d, hyp, 0))),
        library_ms=None,
        bound=bound(tbl_rows_bytes(ids.numel(), delta.shape[0], uniq, C,
                                   True),
                    TBL_FLOPS[rule] * touched_ids(torch, ids, table) * C))
    del a_d, a_s
    return result


def tbl_exact_stateful(torch, rules, rule: str, hyp, device, fused: bool,
                       C: int = TBL_COLS):
    """K13 (or K14, ``fused``, gathering the same ids, in its sorted form
    and in its distinct form on ascending ids) under a stateful rule
    against its plain version on the CPU, bit for bit (int32 views
    of the table, the state and the gathered rows): the kernels fuse a
    product into an add exactly where the reference's XLA does
    (``__fmaf_rn``; ROADMAP C13: momentum's last column the other
    product, in the step at rows up to 29 floats, in the state up to 33)
    and the plain versions take the exact
    fused form (``flush.fma``), so with the phase's hyperparameters,
    whose products round, the two agree to the bit. A 100,000 x C table
    (50: rows not 16-byte aligned, as the bench's; 32: a row whose
    state's last column swaps and whose step's does not; 16: a narrow
    row whose last column swaps in both), 20,000 ids: 5% of them
    repeating another's row, one row at 512 positions, wrapped and
    out-of-range ids, the last 16 ids past the delta's rows; worker 0
    and a worker past the slots. The plain version runs on the CPU,
    where a run's steps add in position order, as the kernels add them.
    Returns (ok, text)."""
    R, n = 100_000, 20_000
    gen = torch.Generator(device=device)
    gen.manual_seed(41)
    table = torch.randn((R, C), generator=gen, device=device) * 0.1
    ids = torch.randint(0, R, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    ids[:n // 20] = ids[n // 20:n // 10]
    ids[2000:2512] = 7
    ids[-8:] = torch.tensor([-1, -R, R, R + 5, -(R + 1), 0, R - 1,
                             2 ** 31 - 1], dtype=torch.int32, device=device)
    delta = torch.randn((n - 16, C), generator=gen, device=device) * 0.01
    state = tbl_state(torch, rule, table, gen)
    # The distinct form's ids: ascending rows, the smallest wrapped, two
    # dropped ids at the end, the last 16 rows past the delta's.
    rows = torch.sort(torch.randperm(R, generator=gen, device=device)[
        :n - 2]).values.to(torch.int32)
    rows[0] -= R
    ascending = torch.cat([rows, torch.tensor([R, -(R + 1)], device=device,
                                              dtype=torch.int32)])
    cpu = torch.device("cpu")
    bad = []
    forms = [(0, ids, False), (3, ids, False)] + (
        [(0, ascending, True), (3, ascending, True)] if fused else [])
    for worker, ids, distinct in forms:
        a_d, a_s = table.clone(), state.clone()
        b_d, b_s = table.to(cpu), state.to(cpu)
        if fused:
            va = rules.rows_apply_gather(rule, a_d, a_s, ids, delta, hyp,
                                         worker, ids, C, distinct=distinct)
            vb = rules.rows_apply_gather_plain(
                rule, b_d, b_s, ids.to(cpu), delta.to(cpu), hyp, worker,
                ids.to(cpu), C, distinct=distinct)
        else:
            rules.row_rule_apply(rule, a_d, a_s, ids, delta, hyp, worker)
            rules.row_rule_apply_plain(rule, b_d, b_s, ids.to(cpu),
                                       delta.to(cpu), hyp, worker)
            va = vb = torch.zeros(1)
        for what, x, y in (("table", a_d, b_d), ("state", a_s, b_s),
                           ("gathered", va, vb)):
            if not torch.equal(x.to(cpu).view(torch.int32),
                               y.view(torch.int32)):
                diff = int((x.to(cpu).view(torch.int32)
                            != y.view(torch.int32)).sum())
                bad.append(f"{'distinct' if distinct else 'sorted'} "
                           f"worker {worker} {what}: {diff} differ")
    text = (f"bit for bit vs the plain version on the CPU at width {C} "
            f"(20,000 ids, repeats, a row at 512 positions, edge ids, ids "
            f"past the delta, workers 0 and 3"
            + ("; and the distinct form on 19,998 ascending ids, the last"
               " 14 past the delta" if fused
               else "") + "): "
            + ("yes" if not bad else f"NO ({'; '.join(bad)})"))
    return not bad, text


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
    grid), within TBL_TOL otherwise. Then the path's own form on the
    (ids, delta) ``sets`` in turn, worker 0, timed with CUDA events
    around queued calls: under a stateful rule the distinct form (the
    engine finds the path's host ids ascending), first held bit for bit
    against its plain version on the CPU at ``sets[0]``, workers 0 and
    past the slots, which gives the entry's max_abs_err; under the
    default rule the sorted form (its path reads a device mirror of the
    ids)."""
    cpu = torch.device("cpu")
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
    tol = ("bit-exact on grid-rounded deltas (values, table)" if exact
           else f"rtol 1e-5 / atol 1e-7 (values, table, state; max err "
                f"{err:g})") + f" on {', '.join(TBL_CASES[:len(cases)])}"
    ids, delta = sets[0]
    distinct = not exact
    if distinct:
        err, path_bad = 0.0, []
        for worker in (0, 1):
            a_d, a_s = table.clone(), state.clone()
            va = rules.rows_apply_gather(rule, a_d, a_s, ids, delta, hyp,
                                         worker, ids, C, distinct=True)
            b_d, b_s = table.to(cpu), state.to(cpu)
            vb = rules.rows_apply_gather_plain(
                rule, b_d, b_s, ids.to(cpu), delta.to(cpu), hyp, worker,
                ids.to(cpu), C, distinct=True)
            for what, x, y in (("values", va, vb), ("table", a_d, b_d),
                               ("state", a_s, b_s)):
                x = x.to(cpu)
                err = max(err, float((x - y).abs().max()))
                if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                    path_bad.append(f"worker {worker} {what}")
            del a_d, a_s, b_d, b_s, va, vb
        failed += [f"the path's distinct form: {b}" for b in path_bad]
        tol += (f"; the path's distinct form on its ascending ids, workers"
                f" 0 and 1 (past the slots), bit for bit vs the plain "
                f"version on the CPU: {'NO' if path_bad else 'yes'}")
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
        tol=tol + (f"; FAILED on {failed}" if failed else ""),
        max_abs_err=err, ok=not failed,
        source="multiverso_tpu_torch/csrc/row_rules.cu",
        replaces="multiverso_tpu/updater/engine.py:155",
        ms=queued_in_turn_ms(torch, [
            lambda i=i, d=d: rules.rows_apply_gather(
                rule, a_d, a_s, i, d, hyp, 0, i, C, distinct=distinct)
            for i, d in sets]),
        plain_ms=time_ms(torch, in_turn(
            [[s] for s in sets], lambda i, d: rules.rows_apply_gather_plain(
                rule, a_d, a_s, i, d, hyp, 0, i, C, distinct=distinct))),
        library_ms=None,
        bound=bound(n_bytes,
                    TBL_FLOPS[rule] * touched_ids(torch, ids, table) * C))
    log(f"[kernel rows_apply_gather @ tbl_fused_{rule}] "
        f"{'distinct' if distinct else 'sorted'} form (the path's): "
        f"{result['ms']:.4f} ms a call (queued events, {len(sets)} sets "
        f"in turn)")
    del a_d, a_s
    return result


def queued_in_turn_ms(torch, calls) -> float:
    """``time_queued_ms`` of ``calls`` made in turn (each set of inputs
    out of L2 by the time its turn comes again)."""
    turn = itertools.cycle(calls)
    return time_queued_ms(torch, lambda: next(turn)())


def tbl_fused_raw(torch, rules, table, id_cases, delta, ascending, hyp,
                  C: int):
    """K14's stateless arm on RAW deltas (no grid: the order of every sum
    shows): under default and sgd, each of ``id_cases`` (repeated,
    wrapped, out-of-range ids, a row at 4,096 positions) launched twice
    must give the same bits, and the same bits as its plain form,
    ``rows.row_scatter_add_ordered`` then ``rows.row_gather_plain``
    (ROADMAP C11); the ascending ``ascending`` ids in the one-writer form
    (``distinct=True``) the same bits twice and as the plain version.
    Returns (ok, max abs error against the plain form, text)."""
    from multiverso_tpu_torch.kernels import rows
    R = table.shape[0]
    err, failed = 0.0, []
    for rule in ("default", "sgd"):
        sign = -1.0 if rule == "sgd" else 1.0
        for name, ids, distinct in list(zip(
                ("ids", "dup", "edges", "run"), id_cases,
                (False,) * 4)) + [("distinct", ascending, True)]:
            got = []
            for _ in range(2):
                t = table.clone()
                got.append((t, rules.rows_apply_gather(
                    rule, t, None, ids, delta, hyp, 0, ids, C,
                    distinct=distinct)))
            want = table.clone()
            if distinct:
                rows.row_scatter_add_plain(want, ids, delta, sign, True)
            else:
                rows.row_scatter_add_ordered(
                    want, rows.scatter_plan(ids, delta.shape[0], R), delta,
                    sign)
            wvals = rows.row_gather_plain(want, ids, C)
            same = all(torch.equal(x, y) for x, y in (
                (got[0][0], got[1][0]), (got[0][1], got[1][1]),
                (got[0][0], want), (got[0][1], wvals)))
            err = max(err, float((got[0][0] - want).abs().max()))
            if not same:
                failed.append(f"{rule}/{name}")
            del got, want, wvals
    text = ("raw deltas, default and sgd, twice and against "
            "row_scatter_add_ordered + row_gather_plain: bit-exact"
            + (f"; FAILED on {failed}" if failed else ""))
    log(f"[kernel rows_apply_gather] {text} (max err {err:g})")
    return not failed, err, text


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
        for entry, fused in ((out[f"tbl_dirty_{suffix}"][0], False),
                             (out[f"tbl_fused_{suffix}"][0], True)):
            for width in (TBL_COLS, 32, 16):
                exact_ok, exact_text = tbl_exact_stateful(
                    torch, rules, suffix, hyp, device, fused, width)
                entry.update(ok=entry["ok"] and exact_ok,
                             tol=f"{entry['tol']}; {exact_text}")
    # The grid of the deltas' largest sum: the row at 4,096 positions.
    base, grid_delta = on_grid(torch, table, run, delta)
    out["tbl_fused_default"] = [tbl_check_fused(
        torch, rules, "default", base, None,
        [(i, grid_delta, 0) for i in (ids, dup, edges, run)], sets, hyp, C)]
    raw_ok, raw_err, raw_text = tbl_fused_raw(
        torch, rules, table, (ids, dup, edges, run), delta, ids, hyp, C)
    fused = out["tbl_fused_default"][0]
    fused.update(ok=fused["ok"] and raw_ok, tol=f"{fused['tol']}; {raw_text}",
                 max_abs_err=max(fused["max_abs_err"], raw_err))
    gather = check_gather(torch, [(table, ids)], C,
                          rotate=[[(table, i)] for i, _ in sets[1:]])
    out["tbl_dirty_default"] = [check_scatter(
        torch, [(table, ids, delta)], C,
        rotate=[[(table, i, d)] for i, d in sets[1:]], distinct=True), gather]
    for suffix, _, _ in TBL_RULES:
        out[f"tbl_dirty_{suffix}"].append(dict(gather))
    del table, base, grid_delta, sets
    for path, entries in out.items():
        report(entries, card, path)
    return out


# Wrappers whose kernels' names hold the wrapper's name, counted in the
# profiled rounds' traces: the profiler can lose cooperative launches.
TBL_TRACED = ("rows_apply_gather", "row_rule_apply", "key_sort")


def tbl_profile(torch, path: str, rounds, workdir: str, profile_dir: str,
                n_rounds: int):
    """(device ms a round of kernels, busy share, lost) of ``n_rounds``
    more rounds under torch.profiler. ``lost`` names each wrapper of
    TBL_TRACED that launched more kernels than the trace holds, with
    both counts: the device ms and busy share are then unreadable."""
    import torch.profiler as tp
    from multiverso_tpu_torch import kernels
    before = kernels.launch_counts()
    with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            rounds()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = kernels.launch_counts()
    trace = os.path.join(profile_dir or workdir, f"{path}_trace.json")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
    _, busy_ms, kernel_ms = trace_kernels(prof, trace)
    lost = []
    for name in TBL_TRACED:
        launched = counted[name] - before[name]
        traced = trace_kernel_sum(trace, name)[0]
        if traced < launched:
            lost.append(f"{name} {traced} traced of {launched}")
    return kernel_ms / n_rounds, busy_ms / (wall * 1e3), lost


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
        dev_ms, busy, lost = tbl_profile(torch, path, one_round, workdir,
                                         profile_dir, iters)
        line += (f" | profiled: device ms a round and busy share "
                 f"unreadable, the trace lost launches ({', '.join(lost)})"
                 if lost else f" | profiled: device {dev_ms:.4f} ms a "
                 f"round, busy {busy:.1%}")
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
        plain_ms=time_ms(torch, lambda: plain(*args), PLAIN_REPS),
        library_ms=None,
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
# The bench corpus's dictionary (phase 12's table rows): K19's shape when
# ``--step-kernels-only mesh_allreduce`` builds no corpus.
MA_BENCH_WORDS = 1_013_245
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
    PyTorch's sequence for the same function and output (``x.mean(0)``
    or ``torch.sum(x, 0)``, then, for ``copies`` > 1, a copy into every
    slot; another summation order, timed only). Inputs
    past 64 MB are timed with CUDA events over ``REPS`` calls: there
    ``time_ms``'s profiler sums have read below the byte bound (PERF.md
    §6); smaller ones with ``time_ms``, whose events would time the
    launches. The mean form is timed in turn with ``x.mean(0)``, five
    rounds, medians."""
    from multiverso_tpu_torch.kernels import mesh
    n, m = x.shape
    got = mesh.mesh_allreduce(x, mean, copies)
    ref = mesh.mesh_allreduce_plain(x, mean, copies)
    same = bool(torch.equal(got.view(torch.int32), ref.view(torch.int32)))
    err = float((got - ref).abs().max())
    del got, ref
    def library():
        total = x.mean(0) if mean else torch.sum(x, 0)
        return total.expand(copies, m).contiguous()

    timer = time_events_ms if n * m * 4 > 64 << 20 else time_ms

    def kernel():
        return mesh.mesh_allreduce(x, mean, copies)
    ms, library_ms = timer(torch, kernel), timer(torch, library)
    if mean:
        # The mean form against ``x.mean(0)``: five rounds, in turn
        # (kernel then library, then backwards ...), medians.
        k_ms, l_ms = [], []
        turn = [(kernel, k_ms), (library, l_ms)]
        for r in range(5):
            for fn, into in (turn if r % 2 == 0 else turn[::-1]):
                into.append(timer(torch, fn))
        ms, library_ms = sorted(k_ms)[2], sorted(l_ms)[2]
        log(f"[kernel mesh_allreduce] mean form vs x.mean(0), in turn, "
            f"M={m}: K19 {[round(t, 4) for t in k_ms]} ms, library "
            f"{[round(t, 4) for t in l_ms]} ms; medians {ms:.4f} / "
            f"{library_ms:.4f}")
    return dict(
        name="mesh_allreduce", tol=f"bit-exact ({'mean' if mean else 'sum'}"
        f", {n} slots, copies {copies}, M={m})", max_abs_err=err, ok=same,
        source=_MA_SRC, replaces=replaces, ms=ms,
        plain_ms=timer(torch, lambda: mesh.mesh_allreduce_plain(
            x, mean, copies)),
        library_ms=library_ms,
        bound=bound((n + copies) * m * 4))


def ma_k19_forms(torch, device):
    """K19's other forms against the plain version, bit for bit: 1, 2, 5
    and 8 slots (the mean to one copy and the sum
    to every slot), M a multiple of 4 and not (the scalar form), and an
    unaligned view (a contiguous tensor 4 bytes past a 16-byte
    boundary). Returns (ok, text)."""
    from multiverso_tpu_torch.kernels import mesh
    bad, cases = [], 0
    for n in (1, 2, 5, 8):
        for m in (1 << 20, (1 << 20) + 3):
            for unaligned in (False, True):
                buf = ma_spread_values(torch, (n * m + 1,), device, 7 + n)
                x = (buf[1:] if unaligned else buf[:-1]).view(n, m)
                for mean, copies in ((True, 1), (False, n)):
                    want = mesh.mesh_allreduce_plain(x, mean, copies)
                    got = mesh.mesh_allreduce(x, mean, copies)
                    cases += 1
                    if not torch.equal(got.view(torch.int32),
                                       want.view(torch.int32)):
                        bad.append(f"n={n} M={m} unaligned={unaligned}"
                                   f" mean={mean}")
    text = (f"other forms bit for bit ({cases} calls: 1, 2, 5, 8 slots, "
            f"M = 2^20 and 2^20 + 3, aligned and not, mean and sum): "
            + ("yes" if not bad else f"NO ({'; '.join(bad[:4])})"))
    return not bad, text


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


def trace_kernel_sum(trace: str, needle: str):
    """(launches, summed ms) of the kernels whose name holds ``needle``
    in a Chrome trace written by ``trace_kernels``."""
    with open(trace) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    durs = [float(e["dur"]) for e in events
            if e.get("cat") == "kernel" and "dur" in e
            and needle in e.get("name", "")]
    return len(durs), sum(durs) / 1e3


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
        forms_ok, forms_text = ma_k19_forms(torch, device)
        mean_form.update(ok=mean_form["ok"] and forms_ok,
                         tol=f"{mean_form['tol']}; {forms_text}")
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
        k19_ms = trace_kernel_sum(trace, "mesh_allreduce")[1]
        all_ms = trace_kernel_sum(trace, "")[1]
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
    point and every kernel of the step is deterministic (K3 sums each
    row's duplicates in a fixed order), so each rank's final tables must
    be bit-identical between sync and overlap and between the two sync
    runs, as the reference's are. Every average copies both tables to
    the host and back (the reference's design): the path is
    host-bound."""
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
            if modes != 0.0 or spread != 0.0:
                raise AssertionError(
                    f"{path}: rank {rank} {name} is not bit-identical "
                    f"between the runs (sync vs overlap {modes:g}, sync vs "
                    f"sync {spread:g}; ROADMAP C11)")
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


def run_step_kernels_phase(torch, np, mv, device, dictionary, tokenized,
                           card: str, dim: int, scale_down: int,
                           only: str = "all"):
    """The word2vec step kernels K4-K7 alone, each held and timed as
    phases 3, 6 and 7 hold it (``step_result``) at the shape of every
    path that runs it (``ps``, the local and PS modes but the per-pair
    ones; ``ps_sgns_g8`` and ``ma_mesh4`` share ``ps``'s and
    ``local_sgns``'s), plus K4 and K5 with a negative block wider than a
    thread block; K12 with K20 (``sparse_lr_apply``; ``key_sort`` K20
    alone) at ``lr_sparse_local``'s shapes; K19 (``mesh_allreduce``) in
    both forms at ``ma_mesh4``'s (``dictionary`` None: the bench
    corpus's size, ``MA_BENCH_WORDS``); named alone, phase 10a's table
    kernel checks (``rows_apply_gather``: ``tbl_kernel_checks``) and
    K9's forms (``pairlist_ns_grad``: ``check_k9_forms``). Those five
    need no corpus. Returns the kernel results."""
    from multiverso_tpu_torch.models.wordembedding import (
        DeviceCorpusTrainer, PSDeviceCorpusTrainer, PSWord2Vec, Word2Vec,
        Word2VecConfig)
    cases = [("ps", dict(neg_block=NEG_BLOCK), CENTERS, 1,
              "banded_sgns_grad", _CSRC + "banded_sgns.cu", _REF + "729",
              True)]
    cases += [(f"local_{m}", f, C, G, k, s, r, False)
              for m, f, C, G, k, s, r in LOCAL_MODES]
    cases += [(p, f, C, G, k, s, r, True) for p, f, C, G, k, s, r in PS_MODES
              if p != "ps_sgns_g8"]
    chosen = set(only.split(",")) if only != "all" else None
    cases = [c for c in cases if chosen is None or c[4] in chosen]
    results = []
    for path, flags, C, G, name, source, replaces, ps in cases:
        config = Word2VecConfig(**{**dict(
            embedding_size=dim, window=WINDOW, negative=NEG, epochs=3,
            min_count=1, sample=1e-3, use_ps=ps), **flags})
        if ps:
            mv.init([], device=None if device.type == "cuda" else "cpu")
            model = PSWord2Vec(config, dictionary)
            trainer = PSDeviceCorpusTrainer(model, tokenized,
                                            C // scale_down, G)
        else:
            model = Word2Vec(config, dictionary, device=device)
            trainer = DeviceCorpusTrainer(model, tokenized, C // scale_down,
                                          G)
        try:
            tables = random_tables(torch, trainer.device,
                                   model_shapes(model))
            kernel, plain, args, n_bytes, flops, _ = step_kernel_case(
                torch, trainer, *tables)
            del tables
            if device.type == "cuda":
                results += report([step_result(
                    torch, kernel, plain, args, n_bytes, flops, name,
                    source, replaces, path)], card, path)
                if path == "ps_per_pair":
                    tables = random_tables(torch, trainer.device,
                                           model_shapes(model))
                    ps_pair_block_step(torch, trainer, *tables, path)
                    del tables
            del args
        finally:
            if ps:
                mv.shutdown()
        del model, trainer
        free(torch, device)
    if device.type == "cuda" and (chosen is None
                                  or "banded_cbow_grad" in chosen):
        check_wide_blocks(torch, device)
    if device.type == "cuda" and (chosen is None
                                  or "sparse_lr_apply" in chosen):
        results += report(lr_apply_case(torch, np, device), card,
                          "lr_sparse_local")
    elif device.type == "cuda" and "key_sort" in chosen:
        keys, values, labels = criteo_like(np, LR_BATCH, seed=9)
        batch = lr_batches(np, keys, values, labels, LR_BATCH)[0]
        results += report([check_key_sort(
            torch, torch.from_numpy(batch.keys.astype(np.int32)).to(device),
            lr_config(_LR_SGD).input_size + 1)], card, "lr_sparse_local")
    if device.type == "cuda" and chosen is not None \
            and "rows_apply_gather" in chosen:
        for entries in tbl_kernel_checks(torch, np, device, card).values():
            results += entries
    if device.type == "cuda" and chosen is not None \
            and "pairlist_ns_grad" in chosen:
        ok, text = check_k9_forms(torch, device)
        log(f"[kernel pairlist_ns_grad] {text}")
        if not ok:
            raise AssertionError(f"pairlist_ns_grad: {text}")
    if device.type == "cuda" and (chosen is None
                                  or "mesh_allreduce" in chosen):
        V = MA_BENCH_WORDS if dictionary is None else dictionary.size
        x = ma_spread_values(torch, (MA_SLOTS, V * dim), device, 12)
        forms = [ma_k19_check(torch, x, _REF + "439", True, 1),
                 ma_k19_check(torch, x, _REF + "439", False, MA_SLOTS)]
        del x
        free(torch, device)
        forms_ok, forms_text = ma_k19_forms(torch, device)
        forms[0].update(ok=forms[0]["ok"] and forms_ok,
                        tol=f"{forms[0]['tol']}; {forms_text}")
        results += report(forms, card, "ma_mesh4")
    return results


# -- phase 13: the BSP sync server, backup workers, metrics, checkpoints --

# ps_bsp2: the main path (PS SGNS at phase 2's settings) on two workers of
# one server under -sync (tests/test_wordembedding.py:585-613 at the
# bench's widths), beside ps_async2, the same two workers without -sync.
# tbl_bsp_<rule>: bench.py matrix_bandwidth's table (1M x 50) on two ranks
# (worker and server each) under -sync, BSP_ROUNDS rounds; in the backup
# run worker 1 retires after BSP_RETIRE rounds.
BSP_ARGV = ["-sync=true", "-metrics_interval_s=0.5"]
BSP_ROUNDS, BSP_RETIRE = 10, 3
BSP_HYP = dict(momentum=0.9, learning_rate=0.01)


def bsp_run(n: int, argv, device, body, roles=None):
    """``body(rank)`` on ``LocalCluster(n, argv, roles)`` on ``device``,
    the flag registry at its defaults before and after (flags are
    process-wide and persist across clusters: phase 12 leaves ``-ma``
    set, this phase ``-sync``, ``-metrics_interval_s`` and
    ``-updater_type``)."""
    from multiverso_tpu_torch.runtime.cluster import LocalCluster
    from multiverso_tpu_torch.util import configure
    configure.reset_flags()
    cluster = LocalCluster(n, argv=list(argv), roles=roles,
                           device=str(device))
    cluster.timeout = 900.0
    try:
        return cluster.run(body)
    finally:
        configure.reset_flags()


def bsp_metrics(zoo) -> dict:
    """Rank 0's controller view after every rank's ``metrics_flush``
    and a barrier: {rank: SERVER_PROCESS_ADD count}."""
    view = zoo._actors["controller"].metrics.cluster_view()
    return {r: int(s["monitors"].get("SERVER_PROCESS_ADD", {})
                   .get("count", 0)) for r, s in view["ranks"].items()}


def bsp_ps_path(torch, np, device, dictionary, tokenized, card: str,
                workdir: str, profile_dir: str, dim: int, scale_down: int,
                path: str, argv, checks: bool, checkpoint: str = ""):
    """Two workers (``roles=["all", "worker"]``: one server) train PS
    SGNS at phase 2's settings on the same corpus with the same seeds
    under ``argv``: a warm-up block, rank 0's kernel checks (``checks``,
    on the card), BLOCKS blocks a worker with the launch counts reset
    just before and read just after (both workers' words over the wall
    time), the same blocks profiled, finite tables, and the controller's
    metrics view. With ``checkpoint`` rank 0 saves the server tables
    there. Returns (kernel results, launch counts, rank 0's tables on the
    card after the run)."""
    from multiverso_tpu_torch import current_zoo, kernels
    from multiverso_tpu_torch.io import save_checkpoint
    from multiverso_tpu_torch.models.wordembedding import (
        PSDeviceCorpusTrainer, PSWord2Vec)
    from multiverso_tpu_torch.util.dashboard import Dashboard
    cuda = device.type == "cuda"
    out = {"words": [0, 0]}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def body(rank):
        t0, prof = time.perf_counter(), None
        model = PSWord2Vec(bsp_config(dim), dictionary)
        trainer = PSDeviceCorpusTrainer(model, tokenized,
                                        CENTERS // scale_down)
        zoo = current_zoo()
        trainer.train_epoch(seed=99, max_steps=1)  # warm-up, calibrates
        if rank == 0:
            log(f"[{path}] 2 workers, 1 server, {argv} | model + trainer "
                f"+ warm-up {time.perf_counter() - t0:.1f}s")
            if checks and cuda:
                out["checks"] = report(ps_kernel_checks(torch, trainer,
                                                        path), card, path)
            sync()
            Dashboard.reset()
            kernels.reset_launch_counts()
        zoo.barrier()
        words0 = model.trained_words
        t0 = time.perf_counter()
        loss, examples = trainer.train_epoch(seed=0, max_steps=BLOCKS)
        sync()  # train_epoch ends in a barrier: both workers are done
        elapsed = time.perf_counter() - t0
        out["words"][rank] = model.trained_words - words0
        if not (math.isfinite(loss) and examples > 0):
            raise AssertionError(f"{path} rank {rank}: loss {loss}, "
                                 f"examples {examples}")
        zoo.barrier()
        if rank == 0:
            out["counts"] = kernels.launch_counts()
            words = sum(out["words"])
            log(f"[{path}] {card} | {BLOCKS} blocks a worker in "
                f"{elapsed:.4f}s | {words / elapsed:.0f} words/s (both "
                f"workers) | {elapsed / BLOCKS * 1e3:.3f} ms a block | "
                f"examples {examples:.0f} a worker | avg loss "
                f"{loss / max(examples, 1):.4f}")
            log(f"[{path}] kernel launches {out['counts']}")
            for line in Dashboard.display().splitlines():
                log(f"[{path}] {line}")
            if cuda:
                import torch.profiler as tp
                prof = tp.profile(activities=[tp.ProfilerActivity.CUDA])
                prof.start()
        zoo.barrier()
        t0 = time.perf_counter()
        trainer.train_epoch(seed=7, max_steps=BLOCKS)
        sync()
        if prof is not None:
            wall = time.perf_counter() - t0
            prof.stop()
            trace = os.path.join(profile_dir or workdir,
                                 f"{path}_trace.json")
            n_kernels, busy_ms, kernel_ms = trace_kernels(prof, trace)
            log(f"[{path}] profiled: {n_kernels} kernels, device "
                f"{kernel_ms / BLOCKS:.4f} ms a block of kernels (both "
                f"workers), busy {busy_ms:.2f} ms of {wall * 1e3:.2f} ms "
                f"wall ({busy_ms / (wall * 1e3):.1%})")
        zoo.barrier()
        if rank == 0:
            check_tables(np, model, path)
            if checkpoint:
                t0 = time.perf_counter()
                n = save_checkpoint(checkpoint)
                log(f"[{path}] checkpoint: {n} server tables saved in "
                    f"{time.perf_counter() - t0:.1f}s")
                out["tables"] = [model._in_table.get_device(),
                                 model._out_table.get_device()]
        zoo.metrics_flush()
        zoo.barrier()
        if rank == 0 and any(a.startswith("-metrics_interval_s=")
                             for a in argv):
            log(f"[{path}] controller metrics: SERVER_PROCESS_ADD by rank "
                f"{dict(sorted(bsp_metrics(zoo).items()))}")

    bsp_run(2, argv, device, body, roles=["all", "worker"])
    return out.get("checks", []), out.get("counts", {}), out.get("tables")


def bsp_config(dim: int, **flags):
    from multiverso_tpu_torch.models.wordembedding import Word2VecConfig
    return Word2VecConfig(**{**dict(
        embedding_size=dim, window=WINDOW, negative=NEG, epochs=3,
        min_count=1, sample=1e-3, use_ps=True, neg_block=NEG_BLOCK),
        **flags})


def bsp_small_run(torch, device, workdir: str):
    """The tests' topic corpus through two workers of one server under
    -sync (6 blocks of 128 centers, draws from one CPU generator a
    worker, the same seeds): rank 0's (losses a block, examples, in
    rows, out rows)."""
    import numpy as np
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
        TorchDraws)
    path = write_topics(workdir)
    dictionary = Dictionary.build(path, min_count=1)
    tokenized = TokenizedCorpus.build(dictionary, path)

    def body(rank):
        model = PSWord2Vec(bsp_config(16, window=3, sample=1e-2),
                           dictionary)
        trainer = PSDeviceCorpusTrainer(
            model, tokenized, centers_per_step=128,
            draws=TorchDraws(device, draw_device="cpu"))
        losses = []
        _, examples = trainer.train_epoch(
            seed=5, max_steps=6, block_hook=lambda _w: losses.append(
                float(trainer.last_loss)))
        return (np.array(losses), examples, model._in_table.get(),
                model._out_table.get())

    return bsp_run(2, ["-sync=true"], device, body,
                   roles=["all", "worker"])[0]


def bsp_checkpoint(torch, np, mv, device, dictionary, dim: int,
                   prefix: str, saved) -> None:
    """``load_checkpoint`` of ps_bsp2's server tables into a fresh zoo
    on ``device``: every row of both tables bit for bit the saved ones;
    then a torn table file raises ``CheckpointError`` with nothing
    restored."""
    from multiverso_tpu_torch.io import CheckpointError, load_checkpoint
    from multiverso_tpu_torch.models.wordembedding import PSWord2Vec

    def bits(t):
        return t.contiguous().view(torch.int32)

    mv.init([], device=str(device))
    try:
        model = PSWord2Vec(bsp_config(dim), dictionary)
        tables = (model._in_table, model._out_table)
        t0 = time.perf_counter()
        n = load_checkpoint(prefix)
        loaded = [t.get_device() for t in tables]
        for name, got, want in zip(("in", "out"), loaded, saved):
            if got.shape != want.shape \
                    or not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"checkpoint: the {name} table's "
                                     f"rows differ after the load")
        log(f"[ps_bsp2] checkpoint: {n} tables loaded into a fresh zoo in "
            f"{time.perf_counter() - t0:.1f}s; every row of both tables "
            f"bit for bit the saved ones ({loaded[0].shape[0]} x "
            f"{loaded[0].shape[1]} each)")
        rows = np.array([0, 5], np.int32)
        tables[0].add_rows(rows, np.ones((2, dim), np.float32))
        live = tables[0].get_device()
        table_file = f"{prefix}.table0.rank0"
        with open(table_file, "rb+") as f:
            f.truncate(os.path.getsize(table_file) - 4)
        try:
            load_checkpoint(prefix)
        except CheckpointError as exc:
            log(f"[ps_bsp2] checkpoint: a torn table file raised "
                f"CheckpointError ({str(exc)[:90]}...)")
        else:
            raise AssertionError("checkpoint: a torn table file loaded")
        if not (torch.equal(bits(tables[0].get_device()), bits(live))
                and torch.equal(bits(tables[1].get_device()),
                                bits(saved[1]))):
            raise AssertionError("checkpoint: the torn load restored "
                                 "something")
        log("[ps_bsp2] checkpoint: nothing restored from the torn one")
    finally:
        mv.shutdown()


def bsp_rows(np, R: int, worker: int):
    """Worker ``worker``'s rows of a round: every TBL_EVERY-th row,
    offset by half of TBL_EVERY a worker (the workers' rows are
    disjoint, so a round's sum does not depend on the order in which
    the server takes the two workers' adds)."""
    return (np.arange(R // TBL_EVERY, dtype=np.int32) * TBL_EVERY
            + worker * (TBL_EVERY // 2)).astype(np.int32)


def bsp_deltas(np, R: int, C: int, worker: int, rounds: int):
    rng = np.random.default_rng(17 + worker)
    n = bsp_rows(np, R, worker).size
    return [(rng.standard_normal((n, C)) * 0.01).astype(np.float32)
            for _ in range(rounds)]


def bsp_tbl_rounds(torch, np, device, R: int, C: int, rule: str,
                   rounds=(BSP_ROUNDS, BSP_ROUNDS), extra=(),
                   profile: bool = False):
    """A dense R x C table on two ranks (each worker and server) under
    -sync (and ``extra`` flags), updater ``rule``: in each round worker
    w adds its rows (``bsp_rows``) and Gets both workers' rows; worker w
    makes ``rounds[w]`` rounds, and one that stops early retires from
    the clocks (``finish_train``). Then rank 0 Gets both workers' rows
    once more, every rank flushes its metrics report, and rank 0 reads
    the controller's view. Returns (per-rank lists of each round's Get,
    the final Get, launch counts of the rounds, host ms a round and the
    profile (device ms, busy share) of rank 0, the metrics by rank)."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import current_zoo, kernels
    from multiverso_tpu_torch.updater import AddOption
    cuda = device.type == "cuda"
    union = np.sort(np.concatenate([bsp_rows(np, R, w) for w in (0, 1)]))
    out = {"gets": [[], []]}

    def body(rank):
        deltas = [torch.from_numpy(d).to(device)
                  for d in bsp_deltas(np, R, C, rank, rounds[rank])]
        rows = bsp_rows(np, R, rank)
        table = mv.create_matrix_table(R, C)
        option = AddOption(worker_id=rank, **BSP_HYP)
        zoo = current_zoo()
        zoo.barrier()
        prof = None
        if rank == 0:
            if cuda:
                torch.cuda.synchronize()
            kernels.reset_launch_counts()
            if profile and cuda:
                import torch.profiler as tp
                prof = tp.profile(activities=[tp.ProfilerActivity.CUDA])
                prof.start()
        zoo.barrier()
        t0 = time.perf_counter()
        for i in range(rounds[rank]):
            table.add_rows(rows, deltas[i], option=option)
            out["gets"][rank].append(table.get_rows(union))
        if rounds[rank] < max(rounds):
            zoo.finish_train()
        if rank == 0:
            if cuda:
                torch.cuda.synchronize()
            out["ms"] = (time.perf_counter() - t0) / rounds[0] * 1e3
            if prof is not None:
                prof.stop()
                with tempfile.TemporaryDirectory() as tmp:
                    _, busy_ms, kernel_ms = trace_kernels(
                        prof, os.path.join(tmp, "trace.json"))
                out["profile"] = (kernel_ms / rounds[0],
                                  busy_ms / (out["ms"] * rounds[0]))
        zoo.barrier()
        if rank == 0:
            out["counts"] = kernels.launch_counts()
            out["final"] = table.get_rows(union)
        zoo.metrics_flush()
        zoo.barrier()
        if rank == 0:
            out["metrics"] = bsp_metrics(zoo)

    bsp_run(2, ["-sync=true", f"-updater_type={rule}",
                "-metrics_interval_s=0.5", *extra], device, body)
    return out


def bsp_shadow(np, R: int, C: int, rounds):
    """The default rule's table after each worker's adds: worker w's rows
    hold the sequential float32 sum of its first k deltas. Returns a
    function (k0, k1) -> the rows of ``bsp_rows``' union after k_w adds
    of worker w."""
    union = np.sort(np.concatenate([bsp_rows(np, R, w) for w in (0, 1)]))
    sums = []
    for w in (0, 1):
        acc = np.zeros((bsp_rows(np, R, w).size, C), np.float32)
        partial = [acc.copy()]
        for d in bsp_deltas(np, R, C, w, rounds[w]):
            acc = acc + d
            partial.append(acc.copy())
        sums.append(partial)
    where = [np.searchsorted(union, bsp_rows(np, R, w)) for w in (0, 1)]

    def state(k0, k1):
        values = np.zeros((union.size, C), np.float32)
        values[where[0]] = sums[0][k0]
        values[where[1]] = sums[1][k1]
        return values

    return state


def bsp_table_checks(torch, np, device, R: int, C: int, card: str):
    """K2, K3 (one writer an element: the server's ascending host ids)
    and K13 under momentum against their plain versions at tbl_bsp's
    shapes: server 0's shard of the 1M x 50 table (storage 128 columns),
    worker 0's add ids and the Get's ids of both workers in that shard."""
    from multiverso_tpu_torch.kernels import rules
    from multiverso_tpu_torch.tables.matrix_table import row_offsets
    from multiverso_tpu_torch.updater import AddOption
    from multiverso_tpu_torch.updater.engine import pad_ids
    S = 128
    n = row_offsets(R, 2)[1]
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    table = torch.randn((n, S), generator=gen, device=device) * 0.1
    table[:, C:] = 0.0
    adds = bsp_rows(np, R, 0)
    adds = adds[adds < n]
    union = np.sort(np.concatenate([bsp_rows(np, R, w) for w in (0, 1)]))
    union = union[union < n]
    ids = torch.from_numpy(pad_ids(adds, n)).to(device)
    get_ids = torch.from_numpy(pad_ids(union, n)).to(device)
    delta = torch.randn((adds.size, C), generator=gen, device=device) * 0.01
    hyp = AddOption(**BSP_HYP).hyper_array()
    out = {"tbl_bsp_default": [
        check_scatter(torch, [(table, ids, delta)], C, distinct=True),
        check_gather(torch, [(table, get_ids)], C)]}
    state = tbl_state(torch, "momentum", table, gen)
    out["tbl_bsp_momentum"] = [
        tbl_check_rule(torch, rules, "momentum",
                       "multiverso_tpu/updater/rules.py:120", table, state,
                       [(ids, delta, 0)], [(ids, delta)], hyp, C),
        dict(out["tbl_bsp_default"][1])]
    del table, state
    for path, entries in out.items():
        report(entries, card, path)
    return out


def bsp_digest(np, arrays) -> str:
    import hashlib
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def run_bsp_phase(torch, np, mv, device, dictionary, tokenized, card: str,
                  workdir: str, profile_dir: str, dim: int,
                  scale_down: int):
    """Phase 13: the BSP sync server (``-sync``) on the card. ``ps_bsp2``,
    the main path on two workers of one server under ``-sync`` (K1, K2,
    K4, K3 against their plain versions, counted and profiled, the topic
    corpus on the card and on the CPU), beside ``ps_async2`` without it;
    the checkpoint of its server tables loaded into a fresh zoo bit for
    bit, and a torn one refused; ``tbl_bsp_default`` and
    ``tbl_bsp_momentum``, matrix_bandwidth's table on two ranks under
    ``-sync`` (K2, K3 / K13 checked and counted; every Get of every
    round bit for bit the same rounds on the CPU, and under the default
    rule the sum of exactly the adds of both workers' rounds so far);
    and backup workers (``-backup_worker_ratio=50``): worker 1 retires
    after BSP_RETIRE rounds, worker 0 finishes all BSP_ROUNDS, the table
    holds the sum of every add, and the controller's metrics count both
    ranks' ``SERVER_PROCESS_ADD``. Returns (kernel results, launch
    counts per path)."""
    cuda = device.type == "cuda"
    R = TBL_ROWS // 1000 if scale_down > 1 else TBL_ROWS
    C = TBL_COLS
    results, counts = [], {}
    prefix = os.path.join(workdir, "bsp_ckpt", "ps_bsp2")
    usage = shutil.disk_usage(workdir)
    log(f"[phase 13] {workdir}: {usage.free / 2 ** 30:.1f} GiB free for "
        f"the checkpoint")
    checks, counts["ps_bsp2"], saved = bsp_ps_path(
        torch, np, device, dictionary, tokenized, card, workdir,
        profile_dir, dim, scale_down, "ps_bsp2", BSP_ARGV, True,
        checkpoint=prefix)
    results += checks
    missing = [k for k in PS_KERNELS if counts["ps_bsp2"].get(k, 0) <= 0]
    if cuda and missing:
        raise AssertionError(f"ps_bsp2 never launched {missing}")
    free(torch, device)
    bsp_checkpoint(torch, np, mv, device, dictionary, dim, prefix, saved)
    del saved
    shutil.rmtree(os.path.dirname(prefix))
    free(torch, device)
    _, counts["ps_async2"], _ = bsp_ps_path(
        torch, np, device, dictionary, tokenized, card, workdir,
        profile_dir, dim, scale_down, "ps_async2", [], False)
    free(torch, device)
    compare_small(np, "ps_bsp2, 6 blocks", bsp_small_run(torch, device,
                                                         workdir),
                  bsp_small_run(torch, torch.device("cpu"), workdir))
    checks = bsp_table_checks(torch, np, device, R, C, card) if cuda else {}
    for rule, need in (("default", ("row_scatter_add", "row_gather")),
                       ("momentum", ("row_rule_apply", "row_gather"))):
        path = f"tbl_bsp_{rule}"
        got = bsp_tbl_rounds(torch, np, device, R, C, rule, profile=cuda)
        ref = bsp_tbl_rounds(torch, np, torch.device("cpu"), R, C, rule)
        counts[path] = got["counts"]
        missing = [k for k in need if counts[path].get(k, 0) <= 0]
        if cuda and missing:
            raise AssertionError(f"{path} never launched {missing}")
        for w in (0, 1):
            for i, (a, b) in enumerate(zip(got["gets"][w], ref["gets"][w])):
                if a.tobytes() != b.tobytes():
                    raise AssertionError(
                        f"{path}: worker {w}'s Get {i} differs from the "
                        f"CPU's (max {float(np.abs(a - b).max()):g})")
        if rule == "default":
            state = bsp_shadow(np, R, C, (BSP_ROUNDS, BSP_ROUNDS))
            for w in (0, 1):
                for i, a in enumerate(got["gets"][w]):
                    if a.tobytes() != state(i + 1, i + 1).tobytes():
                        raise AssertionError(
                            f"{path}: worker {w}'s Get {i} is not the sum "
                            f"of both workers' first {i + 1} adds")
        bytes_round = 2 * (bsp_rows(np, R, 0).size * C * 4
                           + 2 * bsp_rows(np, R, 0).size * C * 4)
        prof = got.get("profile")
        log(f"[{path}] {card} | 2 workers x {BSP_ROUNDS} rounds under "
            f"-sync | {got['ms']:.3f} ms a round (rank 0, host clock"
            f"{', profiler on' if cuda else ''}) | "
            f"{bytes_round / (got['ms'] / 1e3) / 1e9:.3f} "
            f"GB/s (both workers' adds and Gets) | "
            + (f"device {prof[0]:.4f} ms a round, busy {prof[1]:.1%} | "
               if prof else "")
            + f"kernel launches "
            f"{ {k: v for k, v in got['counts'].items() if v} } | every Get "
            f"of both workers bit for bit the CPU's"
            + (" and the sum of exactly both workers' adds so far"
               if rule == "default" else "")
            + f" ({bsp_digest(np, got['gets'][0])})")
        for entry in checks.get(path, []):
            entry["path"] = path
            results.append(entry)
        del got, ref
        free(torch, device)
    rounds = (BSP_ROUNDS, BSP_RETIRE)
    got = bsp_tbl_rounds(torch, np, device, R, C, "default", rounds=rounds,
                         extra=["-backup_worker_ratio=50"])
    if len(got["gets"][0]) != BSP_ROUNDS \
            or len(got["gets"][1]) != BSP_RETIRE:
        raise AssertionError("backup workers: rounds "
                             f"{[len(g) for g in got['gets']]}")
    want = bsp_shadow(np, R, C, rounds)(*rounds)
    if got["final"].tobytes() != want.tobytes():
        raise AssertionError("backup workers: the table is not the sum of "
                             "every add made")
    adds = got["metrics"]
    if sorted(adds) != [0, 1] or min(adds.values()) <= 0:
        raise AssertionError(f"metrics: SERVER_PROCESS_ADD by rank {adds}")
    log(f"[tbl_bsp backup] -backup_worker_ratio=50: worker 1 retired after "
        f"{BSP_RETIRE} rounds, worker 0 made all {BSP_ROUNDS}; the table "
        f"holds the sum of all {sum(rounds)} adds, bit for bit | controller "
        f"metrics: SERVER_PROCESS_ADD by rank {dict(sorted(adds.items()))}")
    return results, counts


def lr_apply_case(torch, np, device):
    """K11 and K12 (with K20) at ``lr_sparse_local``'s shapes (the first
    of phase 9's batches): held and timed as phase 9 holds them, K12
    split launch by launch."""
    keys, values, labels = criteo_like(np, LR_BATCH, seed=9)
    batch = lr_batches(np, keys, values, labels, LR_BATCH)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    return lr_case(torch, np, "lr_sparse_local", lr_config(_LR_SGD),
                   batch, gen, device, ps=False)



# -- phase 14: the client cache, prefetch and 1-bit pushes (A6) --

# bench.py:2052 run_client_cache: table rows and width, rows a Get (before
# unique), the pool of Gets and its passes, the hot rows' add period and
# the staleness bound (versions are per shard: the bound covers the adds
# between two visits of a pool Get), the trainer-shaped steps and their
# simulated 2 ms of compute.
CACHE_ROWS, CACHE_COL, CACHE_PER_GET = 1 << 15, 64, 256
CACHE_POOL, CACHE_PASSES, CACHE_HOT_EVERY, CACHE_BOUND = 80, 3, 24, 24
CACHE_STEPS, CACHE_STEP_S = 60, 0.002
# The host-buffer arm's bound (tests/test_client_cache.py:342).
HOST_ARM_BOUND = 8
HOST_ARM_PATHS = (("hb_ps_host_sgns", False), ("hb_ps_host_1bit", True))


def cache_workload(np, scale_down: int):
    """bench.py's Gets: Zipf(1.0) rows of a 32,768-row table, unique'd
    draws of 256, a pool of 80 repeated over 3 passes, and the hot rows
    (the first 256's draws of 64) its adds touch."""
    rng = np.random.default_rng(11)
    num_row = CACHE_ROWS // scale_down
    probs = 1.0 / np.arange(1, num_row + 1)
    probs /= probs.sum()
    per = max(CACHE_PER_GET // scale_down, 8)
    batches = [np.unique(rng.choice(num_row, size=per, p=probs))
               .astype(np.int32) for _ in range(CACHE_POOL)]
    hot = np.unique(rng.choice(min(256, num_row), size=64)) \
        .astype(np.int32)
    return num_row, batches, batches * CACHE_PASSES, hot


def cache_counts():
    from multiverso_tpu_torch.tables import client_cache
    from multiverso_tpu_torch.util.dashboard import Dashboard
    return {n: Dashboard.get(n).count for n in (
        client_cache.HIT, client_cache.MISS, client_cache.JOIN,
        client_cache.PREFETCH, "SERVER_PROCESS_GET")}


def cache_arm(torch, np, mv, device, work, cached: bool, replay: bool):
    """One arm of bench.py's client-cache phase under its own zoo: a
    table of ``work``'s rows (batch 0's rows set to 1), a warm pass of
    the pool, the timed stream of Gets (each 24th followed by an add of
    ones to the hot rows and their recovery prefetch), then the
    trainer-shaped loop (prefetch step i+1 when cached, 2 ms, Get step
    i). ``replay`` waits each prefetch before the next call, so the
    hit, miss and join counts do not depend on when its reply lands.
    Returns the timed stream's seconds, the Gets (every one, in order),
    the cache's and the dashboard's counts over the stream, the mean
    stall of a trainer-shaped Get, and the launches of the stream."""
    from multiverso_tpu_torch import kernels
    from multiverso_tpu_torch.util import configure
    num_row, batches, stream, hot = work
    cuda = device.type == "cuda"
    argv = [f"-max_get_staleness={CACHE_BOUND}"] if cached else []
    mv.init(argv, device=None if cuda else "cpu")
    try:
        table = mv.create_matrix_table(num_row, CACHE_COL)
        ones = np.ones((hot.size, CACHE_COL), np.float32)
        table.add_rows(batches[0], np.ones((batches[0].size, CACHE_COL),
                                           np.float32))
        gets = [table.get_rows(ids) for ids in batches]   # warm
        cache = table._row_cache
        stats0, counts0 = dict(cache.stats), cache_counts()
        if cuda:
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for i, ids in enumerate(stream):
            gets.append(table.get_rows(ids))
            if i % CACHE_HOT_EVERY == CACHE_HOT_EVERY - 1:
                table.add_rows(hot, ones)
                mid = table.prefetch_rows_async(hot)
                if replay:
                    table.wait(mid)
        elapsed = time.perf_counter() - t0
        launches = kernels.launch_counts()
        stats, counts = dict(cache.stats), cache_counts()
        stall = 0.0
        steps = min(CACHE_STEPS, len(stream))
        for i in range(steps):
            if cached and i + 1 < steps:
                mid = table.prefetch_rows_async(stream[i + 1])
                if replay:
                    table.wait(mid)
            time.sleep(CACHE_STEP_S)
            t0 = time.perf_counter()
            gets.append(table.get_rows(stream[i]))
            stall += time.perf_counter() - t0
        final = cache_counts()
    finally:
        mv.shutdown()
        configure.reset_flags()
    return dict(
        seconds=elapsed, gets=gets, stall_ms=stall / steps * 1e3,
        launches=launches,
        stream={k: stats[k] - stats0[k] for k in (
            "hits", "misses", "rows_hit", "rows_missed")},
        counts={k: counts[k] - counts0[k] for k in counts},
        all_counts={k: final[k] - counts0[k] for k in final})


def cache_kernel_checks(torch, device, work, card: str):
    """K2 and K3 where the cached table's server runs them: K2 gathers a
    missed Get's rows (pool Gets 0-2 in turn, bucket-padded as the
    server pads host ids), K3 adds the hot rows' ones (ascending ids:
    the one-writer form; the server's bucket padding, which drops, left
    off so that ``index_add_`` can take the same ids) — on a random
    table of the server's storage shape (64 columns stored in 128)."""
    from multiverso_tpu_torch.updater.engine import pad_ids
    num_row, batches, _, hot = work
    table = random_tables(torch, device, [(num_row, 128)])[0]
    gets = tuple((table, torch.from_numpy(pad_ids(ids, num_row))
                  .to(device)) for ids in batches[:4])
    ids = torch.from_numpy(hot).to(device)
    delta = torch.zeros((hot.size, 128), device=device)
    delta[:, :CACHE_COL] = 1.0
    return report([check_gather(torch, gets[:1], CACHE_COL,
                                rotate=[gets[1:2], gets[2:3]]),
                   check_scatter(torch, ((table, ids, delta),), CACHE_COL,
                                 distinct=True)], card, "tbl_cache")


def digest_all(np, gets):
    """One digest a Get: its bytes, so two runs' Gets compare exactly."""
    import hashlib
    return [hashlib.sha1(np.ascontiguousarray(g).tobytes()).hexdigest()
            for g in gets]


def cache_path(torch, np, mv, device, card: str, scale_down: int):
    """``tbl_cache``: bench.py's ``run_client_cache`` on the card — the
    uncached and the cached arm (Gets/s of the timed stream, the hit
    rate of its Gets and rows, a trainer-shaped Get's stall without and
    with prefetch), K2 and K3 checked at its server's shapes and
    launched in the cached arm's stream; then the cached arm again on
    the card and on the CPU with each prefetch waited: every Get the
    same bytes, and the same hit, miss, join and prefetch counts; the
    timed arm's Gets the same bytes too."""
    work = cache_workload(np, scale_down)
    cuda = device.type == "cuda"
    results = cache_kernel_checks(torch, device, work, card) if cuda \
        else []
    plain = cache_arm(torch, np, mv, device, work, False, False)
    cached = cache_arm(torch, np, mv, device, work, True, False)
    n = len(work[2])
    s = cached["stream"]
    log(f"[tbl_cache] {card} | {work[0]} x {CACHE_COL}, {n} Gets of ~"
        f"{np.mean([b.size for b in work[1]]):.0f} rows, bound "
        f"{CACHE_BOUND} | uncached {n / plain['seconds']:.1f} Gets/s, "
        f"cached {n / cached['seconds']:.1f} Gets/s "
        f"({plain['seconds'] / cached['seconds']:.3f}x) | hit rate "
        f"{s['hits'] / max(s['hits'] + s['misses'], 1):.4f}, row hit rate "
        f"{s['rows_hit'] / max(s['rows_hit'] + s['rows_missed'], 1):.4f} "
        f"| stall a step {plain['stall_ms']:.3f} ms without prefetch, "
        f"{cached['stall_ms']:.3f} ms with "
        f"({plain['stall_ms'] / max(cached['stall_ms'], 1e-9):.3f}x)")
    log(f"[tbl_cache] timed stream counts: uncached {plain['counts']}, "
        f"cached {cached['counts']}; cached arm in all "
        f"{cached['all_counts']}")
    log(f"[tbl_cache] kernel launches {cached['launches']}")
    missing = [k for k in ("row_gather", "row_scatter_add")
               if cuda and cached["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"tbl_cache never launched {missing}")
    timed = digest_all(np, cached["gets"])
    if digest_all(np, plain["gets"]) != timed:
        raise AssertionError("tbl_cache: the cached arm's Gets differ from "
                             "the uncached arm's")
    card_replay = cache_arm(torch, np, mv, device, work, True, True)
    cpu_replay = cache_arm(torch, np, mv, torch.device("cpu"), work, True,
                           True)
    same = digest_all(np, card_replay["gets"]) \
        == digest_all(np, cpu_replay["gets"]) == timed
    counted = ("counts", "stream", "all_counts")
    if not same or any(card_replay[k] != cpu_replay[k] for k in counted):
        raise AssertionError(
            f"tbl_cache: card and CPU replays differ (Gets equal: {same}; "
            f"card {[card_replay[k] for k in counted]}, CPU "
            f"{[cpu_replay[k] for k in counted]})")
    log(f"[tbl_cache] replay with each prefetch waited: card and CPU "
        f"alike, {len(timed)} Gets bit for bit (the timed arms' too), "
        f"counts {cpu_replay['all_counts']}")
    return results, {"tbl_cache": cached["launches"]}


def host_arm_kernel_checks(torch, model, batch, path: str, card: str):
    """The host-buffer arm's kernels at the first batch's shapes over
    random tables of the model's: K2 as its server gathers the real
    unique rows (bucket-padded host ids), K9 and K3 into the pulled
    buffers' delta (``hb_kernel_case``, as the device arm runs them),
    and K3 as the server adds the sliced host deltas (ascending ids: the
    one-writer form; the bucket padding, which drops, left off so that
    ``index_add_`` can take the same ids)."""
    from multiverso_tpu_torch.kernels import rows
    from multiverso_tpu_torch.updater.engine import pad_ids
    D = model.config.embedding_size
    dev = model_device(model)
    tables = random_tables(torch, dev, model_shapes(model))
    compact = model.prepare(batch)
    real = (compact.rows_in, compact.rows_out)
    pulls = tuple((t, torch.from_numpy(pad_ids(ids, t.shape[0])).to(dev))
                  for t, ids in zip(tables, real))
    results = [check_gather(torch, pulls, D)]
    (kernel, plain, args, bufs, in_rows, out_rows, _, n_bytes,
     flops) = hb_kernel_case(torch, model, batch, tables, True)
    got = kernel(*args)
    err, ok, loss_rel = compare_step(got, plain(*args))
    results.append(dict(
        name="pairlist_ns_grad", tol=f"grads |err| <= 1e-5 + 1e-4 |plain|; "
        f"loss rel err {loss_rel:.2g} <= 1e-5; counts equal",
        max_abs_err=err, ok=ok, source=_CSRC + "pairlist_ns.cu",
        replaces=_MODEL_REF + "755",
        ms=time_ms(torch, lambda: kernel(*args)),
        plain_ms=time_ms(torch, lambda: plain(*args)), library_ms=None,
        bound=bound(n_bytes, flops)))
    scatters = []
    for t, ids, g, buf, pushed in zip(tables, (in_rows, out_rows), got,
                                      bufs, real):
        delta = torch.zeros_like(buf)
        rows.row_scatter_add(delta, ids, g)
        scatters.append((t, torch.from_numpy(pushed).to(dev),
                         delta[:pushed.size].contiguous()))
    results.append(check_scatter(torch, tuple(scatters), D,
                                 distinct=True))
    log(f"[kernel pairlist_ns_grad @ {path}] B={args[4].shape[0]} | "
        f"pulled {real[0].size} + {real[1].size} real rows into buffers "
        f"of {tuple(bufs[0].shape)}, {tuple(bufs[1].shape)}")
    del tables, got, args, bufs, scatters
    return report(results, card, path)


class EncodeTimer:
    """Wraps each table's ``_onebit_chunk`` (an instance attribute over
    the method): the host seconds spent encoding, and each table's first
    call's (rows, chunk, blobs) for the first-push check."""

    def __init__(self, np, tables):
        self.seconds, self.calls, self.first = 0.0, 0, {}
        self._np, self._tables = np, tables
        for t in tables:
            t._onebit_chunk = self._wrap(t, t._onebit_chunk)

    def _wrap(self, table, encode):
        np = self._np

        def timed(chunk, lo, hi, rows=None):
            t0 = time.perf_counter()
            blobs = encode(chunk, lo, hi, rows)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.first.setdefault(id(table), (
                None if rows is None else rows.copy(),
                np.array(chunk, copy=True),
                [b.as_array(np.uint8).copy() for b in blobs]))
            return blobs
        return timed

    def remove(self):
        for t in self._tables:
            del t._onebit_chunk


def onebit_first_push(torch, np, model, batch) -> str:
    """``hb_ps_host_1bit``'s first push, held on the CPU: each table's
    encoded blobs and the worker's residual are the CPU's encode of the
    same host delta, bit for bit, and the rows after the push are the
    rows before it plus the CPU's decode of those blobs, added by the
    plain K3, bit for bit."""
    from multiverso_tpu_torch.kernels import rows
    from multiverso_tpu_torch.tables import matrix_table as mt
    compact = model.prepare(batch)
    tables = (model._in_table, model._out_table)
    ids = (compact.rows_in, compact.rows_out)
    before = [t.get_rows(i).copy() for t, i in zip(tables, ids)]
    timer = EncodeTimer(np, tables)
    try:
        model.train_batch(compact)
    finally:
        timer.remove()
    D = model.config.embedding_size
    for t, i, old in zip(tables, ids, before):
        rows_c, chunk, blobs = timer.first[id(t)]
        chunk2d = np.asarray(chunk).reshape(-1, D)
        want_blobs, residual = mt._onebit_blobs(
            (chunk2d + np.zeros_like(chunk2d)).reshape(-1))
        if not (np.array_equal(rows_c, i) and all(
                w.as_array(np.uint8).tobytes() == g.tobytes()
                for w, g in zip(want_blobs, blobs))
                and t._residual[i].tobytes()
                == residual.reshape(-1, D).tobytes()):
            raise AssertionError("hb_ps_host_1bit: the first push's blobs "
                                 "or residual differ from the CPU's")
        decoded = mt._onebit_decode(*want_blobs).reshape(-1, D)
        want = torch.from_numpy(old.copy())
        rows.row_scatter_add_plain(
            want, torch.arange(i.size, dtype=torch.int32),
            torch.from_numpy(decoded), 1.0)
        after = t.get_rows(i)
        if after.tobytes() != want.numpy().tobytes():
            raise AssertionError("hb_ps_host_1bit: the table after the "
                                 "first push is not the CPU's decode "
                                 "added by the plain K3")
    return (f"first push: blobs and residual the CPU's encode, rows "
            f"{ids[0].size} in + {ids[1].size} out the plain K3's add of "
            f"the CPU's decode, bit for bit")


def small_host_arm(torch, mv, device, workdir: str, host: bool,
                   one_bit: bool = False):
    """The topic corpus, 8 batches of 128 (phase 8's PS small run) on
    ``PSWord2Vec``'s host-buffer arm (``host``) or its device arm, cache
    off: (loss, pairs, input rows, output rows)."""
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, PSWord2Vec, TokenizedCorpus, Word2VecConfig)
    from multiverso_tpu_torch.util import configure
    path = write_topics(workdir)
    dictionary = Dictionary.build(path, min_count=1)
    tokenized = TokenizedCorpus.build(dictionary, path)
    config = Word2VecConfig(embedding_size=16, window=3, negative=5,
                            epochs=2, min_count=1, sample=1e-2,
                            batch_size=128, use_ps=True, neg_block=4)
    batches = hb_batches(dictionary, tokenized, 128, 3, False, 8, 1e-2)
    argv = ["-max_get_staleness=0"] + (["-one_bit_push=true"]
                                       if one_bit else [])
    mv.init(argv, device=str(device))
    try:
        model = PSWord2Vec(config, dictionary)
        model._device_path = not host
        loss, pairs = model.train_batches(iter(batches))
        return (loss, pairs, model._in_table.get(), model._out_table.get())
    finally:
        mv.shutdown()
        configure.reset_flags()


def host_arm_path(torch, np, mv, device, dictionary, tokenized, card: str,
                  workdir: str, profile_dir: str, dim: int,
                  scale_down: int, path: str, one_bit: bool):
    """``hb_ps_host_sgns`` / ``hb_ps_host_1bit``: ``PSWord2Vec``'s
    host-buffer arm at phase 8's ``hb_ps_sgns`` settings (131,072 pairs
    a batch, neg_block 8, D 128) with ``-max_get_staleness=8`` and
    prefetch on (``-one_bit_push=true`` too for the second): its kernels
    checked (K2, K9, K3), the first push held on the CPU (1-bit), 2
    warm-up batches, the 4 batches without prefetch (a Get's stall a
    batch), then with it counted (every kernel launched) and profiled,
    the 1-bit encode's host ms a batch and the process's peak RSS."""
    from multiverso_tpu_torch.models.wordembedding import (
        PSWord2Vec, Word2VecConfig)
    from multiverso_tpu_torch.util import configure
    from multiverso_tpu_torch.util.dashboard import Dashboard
    size, nb, n = HB_PS
    size //= scale_down
    cuda = device.type == "cuda"
    batches = hb_batches(dictionary, tokenized, size, WINDOW, False,
                         n + 2)
    config = Word2VecConfig(embedding_size=dim, window=WINDOW,
                            negative=NEG, epochs=3, min_count=1,
                            sample=1e-3, batch_size=size, neg_block=nb,
                            use_ps=True)
    argv = [f"-max_get_staleness={HOST_ARM_BOUND}"] + (
        ["-one_bit_push=true"] if one_bit else [])
    mv.init(argv, device=None if cuda else "cpu")
    results, timer = [], None
    try:
        model = PSWord2Vec(config, dictionary)
        model._device_path = False
        model._use_prefetch = True
        if cuda:
            results = host_arm_kernel_checks(torch, model, batches[0],
                                             path, card)
        if one_bit:
            log(f"[{path}] {onebit_first_push(torch, np, model, batches[0])}")
            model.train_batches(iter(batches[1:2]))    # warm-up
        else:
            model.train_batches(iter(batches[:2]))     # warm-up
        counted = batches[2:]
        # A Get's stall a batch without prefetch (cache on), then the
        # counted run with it (its profiled repeat too).
        model._use_prefetch = False
        Dashboard.reset()
        model.train_batches(iter(counted))
        stall_off = Dashboard.get("PS_GET_STALL")
        stall_off = stall_off.elapse / max(stall_off.count, 1)
        model._use_prefetch = True
        if one_bit:
            timer = EncodeTimer(np, (model._in_table, model._out_table))
        counts = {path: drive_counted(
            torch, model, path, ("row_gather", "pairlist_ns_grad",
                                 "row_scatter_add"), card, workdir,
            profile_dir, lambda: model.train_batches(iter(counted)),
            len(counted), "batch")}
        stall_on = Dashboard.get("PS_GET_STALL")
        stall_on = stall_on.elapse / max(stall_on.count, 1)
        log(f"[{path}] {card} | a Get's stall a batch: {stall_off:.3f} ms "
            f"without prefetch, {stall_on:.3f} ms with "
            f"({stall_off / max(stall_on, 1e-9):.3f}x)")
        for name, table in (("in", model._in_table),
                            ("out", model._out_table)):
            st = table._row_cache.stats
            log(f"[{path}] {name} table's cache over the whole path: "
                f"{st['hits']} Gets hit, {st['misses']} missed; rows "
                f"{st['rows_hit']} hit, {st['rows_missed']} missed "
                f"({st['row_hit_rate']:.4f}); {st['rows']} cached")
        if timer is not None:
            # One chunk a table a batch (one server).
            log(f"[{path}] 1-bit encode: {timer.calls} chunks, "
                f"{timer.seconds / (timer.calls / 2) * 1e3:.2f} host ms a "
                f"batch (both tables)")
        check_tables(np, model, path)
        residuals = sum(t._residual.nbytes for t in (
            model._in_table, model._out_table) if t._residual is not None)
        log(f"[{path}] peak host memory {host_peak_gib():.2f} GiB (the "
            f"1-bit residuals: {residuals / 1e9:.2f} GB)")
    finally:
        if timer is not None:
            timer.remove()
        mv.shutdown()
        configure.reset_flags()
    return results, counts


def run_cache_phase(torch, np, mv, device, dictionary, tokenized,
                    card: str, workdir: str, profile_dir: str, dim: int,
                    scale_down: int):
    """Phase 14: the client cache, prefetch and 1-bit pushes (ROADMAP
    A6) — ``tbl_cache`` (``cache_path``) and the host-buffer arm's two
    paths (``host_arm_path``), then the topic corpus on the host-buffer
    arm with the cache off: its tables the device arm's bit for bit, on
    the card and on the CPU, and card against CPU as phase 8. Returns
    (kernel results, launch counts per path)."""
    results, counts = cache_path(torch, np, mv, device, card, scale_down)
    for path, one_bit in HOST_ARM_PATHS:
        r, c = host_arm_path(torch, np, mv, device, dictionary, tokenized,
                             card, workdir, profile_dir, dim, scale_down,
                             path, one_bit)
        results += r
        counts.update(c)
        free(torch, device)
    runs = {}
    for dev in (device, torch.device("cpu")):
        host = small_host_arm(torch, mv, dev, workdir, True)
        arm = small_host_arm(torch, mv, dev, workdir, False)
        if host[:2] != arm[:2] or any(
                h.tobytes() != a.tobytes() for h, a in zip(host[2:],
                                                           arm[2:])):
            raise AssertionError(f"host-buffer arm on {dev}: tables differ "
                                 f"from the device arm's")
        runs[dev.type] = host
    log("[hb_ps_host] topic corpus, cache off: the host-buffer arm's "
        "tables the device arm's bit for bit, on the card and on the CPU")
    compare_small(np, "hb_ps_host, 8 batches", runs[device.type],
                  runs["cpu"])
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
    parser.add_argument("--bsp-only", action="store_true",
                        help="build, then run phase 13 (the BSP sync "
                             "server) alone on the bench corpus (no "
                             "result line)")
    parser.add_argument("--cache-only", action="store_true",
                        help="build, then run phase 14 (the client "
                             "cache, prefetch and 1-bit pushes) alone on "
                             "the bench corpus (no result line)")
    parser.add_argument("--logreg-only", action="store_true",
                        help="build, then run phase 9 (logistic "
                             "regression) alone (no result line)")
    parser.add_argument("--step-kernels-only", nargs="?", const="all",
                        default="", metavar="NAMES",
                        help="build, then hold and time the word2vec "
                             "step kernels K4-K8 alone at every path's "
                             "shape, K12 with K20 at lr_sparse_local's and "
                             "K19 at ma_mesh4's (no result line); NAMES "
                             "(comma-separated kernel names, key_sort for "
                             "K20 alone) keeps those alone")
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
        log_ftz(build.library()._name)
    sentences = 400 if rehearsal else None
    centers = 256 if rehearsal else CENTERS
    dim = 16 if rehearsal else DIM
    with tempfile.TemporaryDirectory(prefix="mv_chip_smoke_") as workdir:
        from multiverso_tpu_torch.models.wordembedding import synthetic
        if args.step_kernels_only:
            dictionary = tokenized = None
            if not set(args.step_kernels_only.split(",")) <= {
                    "mesh_allreduce", "key_sort", "sparse_lr_apply",
                    "rows_apply_gather", "pairlist_ns_grad"}:
                dictionary, tokenized = bench_corpus(
                    workdir, sentences or synthetic.SENTENCES)
                reuse_huffman_trees()
            run_step_kernels_phase(torch, np, mv, device, dictionary,
                                   tokenized, card, dim,
                                   64 if rehearsal else 1,
                                   args.step_kernels_only)
            print(card, flush=True)
            return 3 if rehearsal else 0
        if args.logreg_only:
            results, counts = run_logreg_phase(
                torch, np, mv, device, card, workdir, args.profile,
                rehearsal)
            print(json.dumps(kernels_line(results, counts)), flush=True)
            print(card, flush=True)
            return 3 if rehearsal else 0
        if args.multiserver_only or args.ma_only or args.bsp_only \
                or args.cache_only:
            dictionary, tokenized = bench_corpus(
                workdir, sentences or synthetic.SENTENCES)
            phase = run_ma_phase if args.ma_only else run_bsp_phase \
                if args.bsp_only else run_cache_phase if args.cache_only \
                else run_multiserver_phase
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
                  lambda: run_ma_phase(torch, np, mv, *common),
                  lambda: run_bsp_phase(torch, np, mv, *common),
                  lambda: run_cache_phase(torch, np, mv, *common))
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
