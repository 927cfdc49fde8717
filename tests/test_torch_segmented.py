"""Segmented device keys (B11): the port against the JAX package.

The reference's segmented programs are called directly: a fixed ids
program and an identity step through ``_segmented_ids_fn`` and
``_segmented_step_fn`` (``multiverso_tpu/models/wordembedding/
device_train.py:823-920``), against the port's ids step (``_Segmenter``:
a stable ``torch.sort``, the inverse permutation by a scatter, the cut
bounds by ``searchsorted`` and K18's segments) and K17/K18's plain
versions — ids, bounds, permutations and rows bit for bit, at 2 and 4
servers, also past a capacity (the overflow flag set, the reference's
zeros). Then the PS device pipeline on ``LocalCluster(2, roles=["all",
"server"])``, broadcast and segmented at G = 1 and 2, with the
reference's draws replayed (port against JAX at rtol 1e-5 / atol 1e-7);
segmented against broadcast within the port on its own draws (rtol 1e-4
/ atol 1e-6, the reference's own test, ``tests/test_wordembedding.py:
787-826``); and an epoch whose segments outgrow their capacities raises
at its end.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.models.wordembedding import device_train as jdt
from multiverso_tpu_torch.kernels import rows as krows
from multiverso_tpu_torch.kernels import segments as ksegs
from multiverso_tpu_torch.models.wordembedding import device_train as tdt
from multiverso_tpu_torch.runtime.cluster import LocalCluster
from multiverso_tpu_torch.tables.matrix_table import row_offsets
from test_torch_multiserver import assert_runs_match, ps_cluster_run
from test_torch_ps_modes import write_topic_corpus


@pytest.fixture(autouse=True)
def _port_teardown_guard():
    """Every test returns the PORT's role-thread count to its baseline
    (tests/conftest.py guards only the reference's thread registry) and
    leaves the port's flag registry at its defaults."""
    from multiverso_tpu_torch.runtime import thread_roles
    from multiverso_tpu_torch.util import configure
    before = sum(thread_roles.roles_alive().values())
    yield
    configure.reset_flags()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if sum(thread_roles.roles_alive().values()) <= before:
            break
        time.sleep(0.05)
    alive = thread_roles.roles_alive()
    assert sum(alive.values()) <= before, f"port threads leaked: {alive}"


R, D = 50, 6


def _ids(seed, shape, skew):
    """Seeded ids in [0, R) with duplicates, Zipf-like toward row 0 when
    ``skew`` (one server then gets most of them)."""
    rng = np.random.default_rng(seed)
    if skew:
        return np.minimum(rng.zipf(1.6, shape) - 1, R - 1).astype(np.int32)
    return rng.integers(0, R, shape).astype(np.int32)


def _counts(ids, offsets):
    flat = np.sort(ids.ravel())
    return np.diff(np.searchsorted(flat, np.asarray(offsets)))


@pytest.mark.parametrize("n_servers", [2, 4])
@pytest.mark.parametrize("overflow", [False, True])
def test_segment_programs_match_reference(n_servers, overflow):
    offsets = tuple(row_offsets(R, n_servers))
    in_ids = _ids(1, (2, 40), skew=False)     # a G=2 group's id blocks
    out_ids = _ids(2, (2, 90), skew=True)
    caps_in = tdt._segment_caps(_counts(in_ids, offsets), in_ids.size)
    caps_out = tdt._segment_caps(_counts(out_ids, offsets), out_ids.size)
    if overflow:
        # Force the Zipf head's server past its capacity.
        caps_out = (8,) + caps_out[1:]
    assert caps_in == jdt._segment_caps(_counts(in_ids, offsets),
                                        in_ids.size)
    aux = jnp.zeros(1)
    seg_ids = jdt._segmented_ids_fn(
        lambda: (jnp.asarray(in_ids), jnp.asarray(out_ids), aux), offsets,
        caps_in, caps_out, R)
    segs_i, segs_o, _, meta_i, meta_o, ovf = seg_ids()
    assert int(ovf) == int(overflow)

    port = [tdt._Segmenter(offsets, caps, R, torch.device("cpu")).prep(
        torch.from_numpy(ids)) for ids, caps in ((in_ids, caps_in),
                                                 (out_ids, caps_out))]
    for got, segs, meta in zip(port, (segs_i, segs_o), (meta_i, meta_o)):
        assert len(got.segments) == n_servers
        for g, w in zip(got.segments, segs):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip((got.order, got.inv, got.bounds), meta):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(port[0].overflow | port[1].overflow) == int(overflow)

    # Each server's reply: its bounded gather (K15) of its segment.
    gen = np.random.default_rng(3)
    table = gen.standard_normal((R, D)).astype(np.float32)
    windows = [(offsets[s], offsets[s + 1] - offsets[s])
               for s in range(n_servers)]

    def replies(segments):
        return [krows.row_gather_bounded_plain(
            torch.from_numpy(table[ofs:ofs + n]), torch.from_numpy(
                np.array(seg)), ofs, n, D).numpy()
            for seg, (ofs, n) in zip(segments, windows)]

    parts_v, parts_u = replies(segs_i), replies(segs_o)
    seg_step = jdt._segmented_step_fn(
        lambda v, u, aux, lr, iw: (v, u, v, u), caps_in, caps_out,
        in_ids.shape, out_ids.shape)
    want_dv, want_du, want_v, want_u = seg_step(
        tuple(jnp.asarray(p) for p in parts_v),
        tuple(jnp.asarray(p) for p in parts_u), meta_i, meta_o, aux,
        jnp.float32(0.1), jnp.float32(1.0))
    for got, parts, want_rows, want_segs in (
            (port[0], parts_v, want_v, want_dv),
            (port[1], parts_u, want_u, want_du)):
        merged = got.merge([torch.from_numpy(p) for p in parts])
        np.testing.assert_array_equal(
            merged.numpy(), np.asarray(want_rows).reshape(-1, D))
        for g, w in zip(got.split(merged), want_segs):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if overflow:
        # The overflowed positions pulled zero rows, as in the reference.
        assert not np.asarray(want_u).any(axis=-1).all()


def test_segment_kernels_plain_edges():
    # K17 and K18 on their own: an empty segment, a capacity past the ids'
    # end (fill), a segment cut short (zeros), the int32 instance.
    src = torch.arange(10, dtype=torch.int32) * 7 % 10   # a permutation
    sorted_ids, order = torch.sort(src, stable=True)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(10))
    bounds = torch.tensor([0, 4, 4, 10], dtype=torch.int32)
    caps = (8, 2, 4)
    segs = ksegs.segment_split(src, order, bounds, caps, fill=99)
    assert [s.tolist() for s in segs] == [
        [0, 1, 2, 3, 4, 5, 6, 7], [4, 5], [4, 5, 6, 7]]
    rows = (torch.arange(10, dtype=torch.float32)[:, None]
            * torch.ones(1, 3))
    parts = [torch.where((s >= lo) & (s < hi), s, -1)[:, None].float()
             * torch.ones(1, 3) for s, lo, hi in
             zip(segs, (0, 4, 4), (4, 4, 10))]
    merged = ksegs.segment_merge(parts, bounds, inv, caps)
    want = rows[src.long()].clone()
    want[(src >= 8)] = 0.0      # server 2 holds 4 of its 6 rows
    np.testing.assert_array_equal(merged.numpy(), want.numpy())
    split = ksegs.segment_split(merged, order, bounds, caps)
    assert [tuple(s.shape) for s in split] == [(8, 3), (2, 3), (4, 3)]
    np.testing.assert_array_equal(split[0][:, 0].numpy(),
                                  [0, 1, 2, 3, 4, 5, 6, 7])


@pytest.mark.parametrize("segment", [False, True])
@pytest.mark.parametrize("G", [1, 2])
def test_ps_pipeline_two_servers_matches_reference(tmp_path, segment, G):
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    flags, C, blocks = dict(neg_block=8), 128, 4
    want = ps_cluster_run(jmv, path, flags, C, G, blocks, seed=3,
                          segment=segment)
    got = ps_cluster_run(tmv, path, flags, C, G, blocks, seed=3,
                         segment=segment)
    assert_runs_match(got, want)


@pytest.mark.parametrize("G", [1, 2])
def test_segmented_matches_broadcast(tmp_path, G):
    # The reference's tests/test_wordembedding.py:787-826 on the port's
    # own draws: the same update math, leaner routing; only the order of
    # duplicate adds may differ.
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
        Word2VecConfig)
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))

    def run(segment):
        def body(rank):
            config = Word2VecConfig(embedding_size=16, window=3, epochs=2,
                                    init_learning_rate=0.01,
                                    batch_size=1024, sample=0)
            model = PSWord2Vec(config, d)
            if rank == 1:   # the server-only rank holds the second shard
                for _ in range(2):
                    tmv.current_zoo().barrier()
                return None
            trainer = PSDeviceCorpusTrainer(
                model, tok, centers_per_step=128, blocks_per_dispatch=G,
                segment_keys=segment)
            for epoch in range(2):
                trainer.train_epoch(seed=epoch)
            assert (trainer._seg_ids is not None) == segment
            return model._in_table.get_rows(np.arange(d.size,
                                                      dtype=np.int32))
        return LocalCluster(2, roles=["all", "server"],
                            device="cpu").run(body)[0]

    broadcast, segmented = run(False), run(True)
    np.testing.assert_allclose(segmented, broadcast, rtol=1e-4, atol=1e-6)


def test_overflowing_epoch_raises_at_its_end(tmp_path, monkeypatch):
    from multiverso_tpu_torch.models.wordembedding import (
        Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
        Word2VecConfig)
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=50)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    # Capacities far under the calibration sample's counts.
    monkeypatch.setattr(tdt, "_segment_caps",
                        lambda counts, total: tuple(8 for _ in counts))
    blocks = []

    def body(rank):
        model = PSWord2Vec(Word2VecConfig(embedding_size=8, sample=0), d)
        if rank == 1:
            tmv.current_zoo().barrier()
            return None
        trainer = PSDeviceCorpusTrainer(model, tok, centers_per_step=64,
                                        segment_keys=True)
        trainer.train_epoch(seed=0, block_hook=lambda _w: blocks.append(1))

    with pytest.raises(RuntimeError, match="overflowed"):
        LocalCluster(2, roles=["all", "server"], device="cpu").run(body)
    assert len(blocks) > 1   # raised at the epoch's end, not at a block
