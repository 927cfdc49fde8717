#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multiverso_tpu_torch``) on one
CUDA card.

Phases, each fatal on failure:

1. build the four hand-written kernels from ``multiverso_tpu_torch/csrc``
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
   for K2-K4), and time kernel, plain version and — where one PyTorch
   call computes the same function — that call, with CUDA events;
4. drive the main path — ``train_epoch`` for 8 blocks through the worker
   and server actors — with every launch count set to 0 just before and
   read just after; every kernel must have launched;
5. check the result: finite losses and rows of the right shapes, and the
   same small input (the topic corpus of the tests) trained on the card
   and on the CPU with the same draws agreeing per block.

Prints one JSON ``kernels`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero with
no result when CUDA is not available or the package is missing.

Usage: ``python3 chip_smoke.py`` (one card). ``--profile DIR`` adds a
``torch.profiler`` trace of 8 more blocks (Chrome trace in DIR, the
device's busy share and the host monitors). ``--cpu-rehearsal`` runs
phases 2, 4 and 5 at a tiny size on the CPU with the plain versions (no
kernels, no result line, exit code 3) to check the control flow on a
host without a card.
"""

from __future__ import annotations

import argparse
import gc
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


def time_ms(torch, fn, reps: int = REPS) -> float:
    """Device time of one ``fn()`` call: the summed duration of every
    kernel it launches, from a ``torch.profiler`` trace of ``reps``
    calls after warm-up, divided by ``reps``. (CUDA events around a call
    of a ~20 us kernel would also time the Python wrapper's launch.)"""
    import torch.profiler as tp
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        total_us += float(getattr(evt, "self_device_time_total", 0.0))
    if total_us <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return total_us / reps / 1e3


def bound(bytes_moved: float, flops: float = 0.0):
    """(least time in ms, what bounds it) on the published peaks."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def setup_main_path(torch, mv, device, workdir: str, sentences: int,
                    centers: int, dim: int):
    """Phase 2: corpus, dictionary, zoo, model and trainer."""
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
        Word2VecConfig)
    from multiverso_tpu_torch.models.wordembedding import synthetic
    t0 = time.perf_counter()
    path = os.path.join(workdir, "corpus.txt")
    synthetic.write_corpus(path, sentences)
    dictionary = Dictionary.build(path, min_count=synthetic.MIN_COUNT)
    tokenized = TokenizedCorpus.build(dictionary, path)
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
    return model, trainer


def block0_inputs(torch, trainer):
    """The main path's inputs at block 0: K1's inputs and outputs and
    the first block's ids."""
    from multiverso_tpu_torch.models.wordembedding import device_train
    corpus = trainer._corpus
    C, B = trainer._C, trainer._B
    W, K = trainer.config.window, trainer.config.negative
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(1234)
    u = torch.rand(corpus.n_tokens, generator=gen, device=trainer.device)
    kept, ksent, n_kept = corpus.prep_epoch(u)
    kept_pad, ksent_pad = device_train._pad_stream(C, W, kept, ksent)
    draws = device_train.TorchDraws(trainer.device).block_draws(
        0, 0, C, W, C // B, K, int(trainer._neg_prob.shape[0]))
    in_ids, out_ids, pmask = device_train._block_ids(
        C, W, kept_pad, ksent_pad, trainer._neg_prob, trainer._neg_alias,
        draws, 0, int(n_kept))
    return u, in_ids, out_ids, pmask


def check_kernels(torch, trainer, card: str):
    """Phase 3: every kernel against its plain version, timed."""
    from multiverso_tpu_torch.kernels import rows, sgns, subsample
    corpus = trainer._corpus
    dev = trainer.device
    C, B = trainer._C, trainer._B
    W, K = trainer.config.window, trainer.config.negative
    D = trainer.config.embedding_size
    u, in_ids, out_ids, pmask = block0_inputs(torch, trainer)
    results = []

    # K1 subsample_compact: bit-exact.
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

    results.append(dict(
        name="subsample_compact", tol="bit-exact", max_abs_err=float(err),
        ok=err == 0,
        source="multiverso_tpu_torch/csrc/subsample_compact.cu",
        replaces="multiverso_tpu/models/wordembedding/device_train.py:61",
        ms=time_ms(torch, lambda: subsample.subsample_compact(
            corpus.flat, corpus.sent, corpus.keep, u)),
        plain_ms=time_ms(torch, lambda: subsample.subsample_compact_plain(
            corpus.flat, corpus.sent, corpus.keep, u)),
        library_ms=time_ms(torch, library_partition),
        bound=bound(T * 4 * 3 + V * 4 + T * 4 * 2 + 4)))

    # Tables for K2-K4: random rows (the model's output table is still
    # zero), the main path's heights and width.
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    table_in = torch.randn(trainer.model._in_table.num_row, D,
                           generator=gen, device=dev) * 0.5
    table_out = torch.randn(trainer.model._out_table.num_row, D,
                            generator=gen, device=dev) * 0.5

    # K2 row_gather at the output table's id count: bit-exact.
    err = 0.0
    for table, ids in ((table_in, in_ids), (table_out, out_ids)):
        g = rows.row_gather(table, ids, D)
        r = rows.row_gather_plain(table, ids, D)
        err = max(err, float((g - r).abs().max()))
    k = out_ids.numel()
    uniq = int(torch.unique(out_ids).numel())
    ids64 = out_ids.to(torch.int64)
    results.append(dict(
        name="row_gather", tol="bit-exact", max_abs_err=err, ok=err == 0.0,
        source="multiverso_tpu_torch/csrc/row_gather.cu",
        replaces="multiverso_tpu/tables/matrix_table.py:2761",
        ms=time_ms(torch, lambda: rows.row_gather(table_out, out_ids, D)),
        plain_ms=time_ms(torch, lambda: rows.row_gather_plain(
            table_out, out_ids, D)),
        library_ms=time_ms(torch, lambda: table_out.index_select(0,
                                                                 ids64)),
        bound=bound(k * 4 + uniq * D * 4 + k * D * 4)))

    # K3 row_scatter_add: duplicates sum in a varying order.
    delta = torch.randn(k, D, generator=gen, device=dev) * 1e-2
    a = table_out.clone()
    b = table_out.clone()
    rows.row_scatter_add(a, out_ids, delta, 1.0)
    rows.row_scatter_add_plain(b, out_ids, delta, 1.0)
    err = float((a - b).abs().max())
    tol3 = 1e-5
    del a, b
    scratch = table_out.clone()
    results.append(dict(
        name="row_scatter_add", tol=f"max_abs_err <= {tol3:g}",
        max_abs_err=err, ok=err <= tol3,
        source="multiverso_tpu_torch/csrc/row_scatter_add.cu",
        replaces="multiverso_tpu/updater/rules.py:94",
        ms=time_ms(torch, lambda: rows.row_scatter_add(scratch, out_ids,
                                                       delta, 1.0)),
        plain_ms=time_ms(torch, lambda: rows.row_scatter_add_plain(
            scratch, out_ids, delta, 1.0)),
        library_ms=time_ms(torch, lambda: scratch.index_add_(0, ids64,
                                                             delta)),
        bound=bound(k * 4 + k * D * 4 + 2 * uniq * D * 4)))
    del scratch

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

    for r in results:
        lib = "n/a" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        log(f"[kernel {r['name']}] {card} | max_abs_err {r['max_abs_err']:g} "
            f"({r['tol']}) {'OK' if r['ok'] else 'FAIL'} | kernel "
            f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | library "
            f"{lib} | bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain "
                             f"versions: {bad}")
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
    trace = os.path.join(outdir, "ps_blocks_trace.json")
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
    gaps = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    log(f"[profile] {card} | {blocks} blocks in {wall * 1e3:.1f} ms wall "
        f"| {len(spans)} kernels, device busy {busy / 1e3:.2f} ms "
        f"({busy / 1e3 / (wall * 1e3):.1%} of wall) | per-block host ms "
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


def small_run(torch, mv, device, workdir: str):
    """Phase 5b helper: the tests' topic corpus, 6 blocks of 128
    centers, draws from one CPU generator; returns (losses, in, out)."""
    import numpy as np
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
        TorchDraws, Word2VecConfig)
    path = os.path.join(workdir, "topics.txt")
    rng = np.random.default_rng(0)
    topics = [[f"a{i}" for i in range(8)], [f"b{i}" for i in range(8)]]
    with open(path, "w") as f:
        for _ in range(800):
            f.write(" ".join(rng.choice(topics[rng.integers(0, 2)],
                                        size=12)) + "\n")
    dictionary = Dictionary.build(path, min_count=1)
    tokenized = TokenizedCorpus.build(dictionary, path)
    mv.init([], device=str(device))
    try:
        config = Word2VecConfig(embedding_size=16, window=3, negative=5,
                                epochs=2, min_count=1, sample=1e-2,
                                use_ps=True, neg_block=8)
        model = PSWord2Vec(config, dictionary)
        trainer = PSDeviceCorpusTrainer(
            model, tokenized, centers_per_step=128,
            draws=TorchDraws(device, draw_device="cpu"))
        losses = []
        trainer.train_epoch(seed=5, max_steps=6,
                            block_hook=lambda _w: losses.append(
                                float(trainer.last_loss)))
        return (np.array(losses), model._in_table.get(),
                model._out_table.get())
    finally:
        mv.shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="tiny CPU run of the control flow (no "
                             "kernels, no result line, exit 3)")
    parser.add_argument("--profile", metavar="DIR", default="",
                        help="also profile 8 blocks of the main path "
                             "(torch.profiler trace and host monitors "
                             "into DIR)")
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
        model, trainer = setup_main_path(
            torch, mv, device, workdir,
            sentences or synthetic.SENTENCES, centers, dim)
        # The ~1M-word dictionary and the corpus are long-lived: keep
        # the cyclic GC from re-walking them in the timed blocks (a full
        # collection of this heap takes tens of ms).
        gc.collect()
        gc.freeze()
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
            missing = [n for n, c in counts.items() if c <= 0]
            if missing:
                raise AssertionError(f"main path never launched {missing}")
            ref = small_run(torch, mv, torch.device("cpu"), workdir)
            got = small_run(torch, mv, device, workdir)
            for name, g, r in zip(("losses", "in rows", "out rows"), got,
                                  ref):
                np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6,
                                           err_msg=name)
            log(f"[small input] card vs CPU plain path: 6 block losses and "
                f"both tables agree (rtol 1e-4, atol 1e-6); max loss diff "
                f"{float(np.abs(got[0] - ref[0]).max()):g}")
    log(f"[done] {time.perf_counter() - started:.1f}s")
    if rehearsal:
        return 3
    kernels_line = {"kernels": [dict(
        name=r["name"], route="cuda", source=r["source"],
        replaces=r["replaces"], launches=int(counts[r["name"]]),
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound"][0], bound_by=r["bound"][1],
        library_ms=r["library_ms"]) for r in results]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
