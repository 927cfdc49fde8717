"""The host-batch word2vec trainer of the port against the JAX package's.

- K9 ``pairlist_ns_grad`` and K10 ``pairlist_hs_grad`` (the plain
  versions, on CPU tensors) against ``jax.value_and_grad`` of the
  reference's ``Word2Vec._compact_loss``: the loss and both tables'
  gradients (the kernels' per-position rows scatter-added into zeros)
  at rtol 1e-5 / atol 1e-7 — float32 sums of the same terms in another
  order. Skip-gram and CBOW, neg_block 1 and 4, duplicate slots, CBOW
  windows with holes and with no context, masked pairs, slot maps given
  as int32 and as the reference's uint16, and exact ties (a zero output
  table, where every logit is 0 and JAX's gradient is -y; logits of
  exactly +-6, where the clip gradient halves).
- ``Word2Vec.prepare`` / ``CompactBatch`` bit-identical to the
  reference's for the same batches and seed, in all four modes.
- Local ``Word2Vec.train_batches`` in all four modes against the
  reference's (which runs groups of ``batch_group``) from identical
  tables, the reference's ``fold_in(key, counter)`` negative draws
  replayed: loss sum, pair count, ``trained_words`` and both tables.
- ``PSWord2Vec.train_batches`` in all four modes against the
  reference's, each under its own ``init``: the numpy draws are the
  same, so nothing is replayed.
- The CLI's ``-device_pipeline=false`` writing vectors, locally and
  through the parameter server.
"""

import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.models.wordembedding import (
    Dictionary as JDictionary, PSWord2Vec as JPSWord2Vec,
    TokenizedCorpus as JTokenizedCorpus, Word2Vec as JWord2Vec,
    Word2VecConfig as JConfig, iter_pair_batches as j_iter_pair_batches)
from multiverso_tpu_torch.kernels.pairlist import (pairlist_hs_grad,
                                                   pairlist_ns_grad)
from multiverso_tpu_torch.kernels.rows import row_scatter_add_plain
from multiverso_tpu_torch.models.wordembedding import (
    BlockLoader, Dictionary, PSWord2Vec, TokenizedCorpus, Word2Vec,
    Word2VecConfig, iter_pair_batches)
from multiverso_tpu_torch.models.wordembedding.convert import (
    load_reference_embeddings)
from multiverso_tpu_torch.models.wordembedding.data import PairBatch
from multiverso_tpu_torch.models.wordembedding.model import _ids_on

RTOL, ATOL = 1e-5, 1e-7
SCALE = np.float32(-0.025)
CPU = torch.device("cpu")

MODES = {
    "sgns": dict(neg_block=4),
    "cbow": dict(cbow=True, neg_block=4),
    "hs_sg": dict(hs=True, negative=0),
    "hs_cbow": dict(hs=True, cbow=True, negative=0),
}


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


def write_topic_corpus(path, n_sentences=300, seed=0):
    """Two topic clusters; words co-occur only within their topic (the
    corpus of tests/test_wordembedding.py)."""
    rng = np.random.default_rng(seed)
    topics = [[f"a{i}" for i in range(8)], [f"b{i}" for i in range(8)]]
    lines = []
    for _ in range(n_sentences):
        topic = topics[rng.integers(0, 2)]
        lines.append(" ".join(rng.choice(topic, size=12)))
    path.write_text("\n".join(lines))


# -- K9 / K10 plain versions vs jax.value_and_grad(_compact_loss) --

def _kernel_case(rng, mode, nb, case, slot_dtype):
    """Random buffers and slot maps for one parity case, as the
    reference's ``in_args``/``out_args`` (numpy, ``slot_dtype`` for the
    slot maps the reference narrows)."""
    B, W2, K, L, D, R_in, R_out = 32, 6, 5, 6, 16, 24, 40
    cbow, hs = "cbow" in mode, mode.startswith("hs")
    ein = (rng.standard_normal((R_in, D)) * 1.2).astype(np.float32)
    eout = (rng.standard_normal((R_out, D)) * 1.2).astype(np.float32)
    if case == "zero":            # every logit exactly 0
        eout[:] = 0.0
    elif case == "six":           # every logit exactly +-6
        ein[:] = 0.0
        ein[:, 0] = 6.0
        eout[:] = 0.0
        eout[::2, 0] = 1.0
        eout[1::2, 0] = -1.0
    pair_mask = (rng.random(B) < 0.85).astype(np.float32)
    pair_mask[-3:] = 0.0          # the padded tail of a short batch
    if cbow:
        win_l = rng.integers(0, R_in, (B, W2)).astype(slot_dtype)
        win_mask = (rng.random((B, W2)) < 0.6).astype(np.float32)
        win_mask[:2] = 0.0        # windows with no context
        win_mask[2, :] = 1.0      # a full window
        in_args = (win_l, win_mask)
    else:
        in_args = (rng.integers(0, R_in, B).astype(slot_dtype),)
    if hs:
        points = rng.integers(0, R_out, (B, L)).astype(slot_dtype)
        codes = np.full((B, L), -1, np.int32)
        for i, n in enumerate(rng.integers(1, L + 1, B)):
            codes[i, :n] = rng.integers(0, 2, n)
        out_args = (points, codes)
    else:
        out_args = (rng.integers(0, R_out, B).astype(slot_dtype),
                    rng.integers(0, R_out, (B // nb, K)).astype(slot_dtype))
    return ein, eout, in_args, out_args, pair_mask


def _port_grads(mode, ein, eout, in_args, out_args, pair_mask):
    """The port's kernel on the case: (loss, count, grad of ein, grad of
    eout), the gradients as K3 would sum the per-position rows."""
    cbow, hs = "cbow" in mode, mode.startswith("hs")
    in_idx = _ids_on(in_args[0], CPU)
    win_mask = torch.from_numpy(in_args[1]) if cbow else None
    pm = torch.from_numpy(pair_mask)
    e_in, e_out = torch.from_numpy(ein), torch.from_numpy(eout)
    if hs:
        points, codes = (_ids_on(a, CPU) for a in out_args)
        d_in, d_out, loss, count = pairlist_hs_grad(
            e_in, e_out, in_idx, win_mask, points, codes, pm, float(SCALE))
        out_rows = points.reshape(-1)
        # A masked node's row is exactly zero.
        masked = ((codes < 0) | (pm[:, None] == 0)).reshape(-1)
        assert not d_out[masked].any()
    else:
        tgt, neg = (_ids_on(a, CPU) for a in out_args)
        d_in, d_out, loss, count = pairlist_ns_grad(
            e_in, e_out, in_idx, win_mask, tgt, neg, pm, float(SCALE))
        out_rows = torch.cat([tgt, neg.reshape(-1)])
    g_in = torch.zeros_like(e_in)
    g_out = torch.zeros_like(e_out)
    row_scatter_add_plain(g_in, in_idx.reshape(-1), d_in)
    row_scatter_add_plain(g_out, out_rows, d_out)
    return float(loss), float(count), g_in.numpy(), g_out.numpy()


KERNEL_CASES = ([(m, nb) for m in ("sgns", "cbow") for nb in (1, 4)]
                + [("hs_sg", 1), ("hs_cbow", 1)])


@pytest.mark.parametrize("slot_dtype", [np.int32, np.uint16],
                         ids=["int32", "uint16"])
@pytest.mark.parametrize("case", ["random", "zero", "six"])
@pytest.mark.parametrize("mode,nb", KERNEL_CASES)
def test_pairlist_grads_match_jax(mode, nb, case, slot_dtype):
    rng = np.random.default_rng(sum(map(ord, f"{mode}{nb}{case}")))
    ein, eout, in_args, out_args, pair_mask = _kernel_case(
        rng, mode, nb, case, slot_dtype)
    config = SimpleNamespace(cbow="cbow" in mode, hs=mode.startswith("hs"))
    loss_fn = JWord2Vec._compact_loss(SimpleNamespace(config=config))
    want_loss, (want_in, want_out) = jax.value_and_grad(
        loss_fn, argnums=(0, 1))(
        jnp.asarray(ein), jnp.asarray(eout),
        tuple(jnp.asarray(a) for a in in_args),
        tuple(jnp.asarray(a) for a in out_args), jnp.asarray(pair_mask))
    loss, count, g_in, g_out = _port_grads(mode, ein, eout, in_args,
                                           out_args, pair_mask)
    np.testing.assert_allclose(loss, float(want_loss), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g_in, SCALE * np.asarray(want_in),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g_out, SCALE * np.asarray(want_out),
                               rtol=RTOL, atol=ATOL)
    has_ctx = in_args[1].sum(1) > 0 if "cbow" in mode else 1.0
    assert count == float((pair_mask * has_ctx).sum())
    if case == "random":
        assert np.abs(g_out).max() > 0 and np.abs(g_in).max() > 0
    if "cbow" in mode:
        # No context: exactly zero input gradient for those windows.
        in_idx = _ids_on(in_args[0], CPU)
        win_mask = torch.from_numpy(in_args[1])
        kernel = pairlist_hs_grad if mode.startswith("hs") \
            else pairlist_ns_grad
        d_in = kernel(torch.from_numpy(ein), torch.from_numpy(eout),
                      in_idx, win_mask,
                      *(_ids_on(a, CPU) for a in out_args),
                      torch.from_numpy(pair_mask), float(SCALE))[0]
        assert not d_in.reshape(32, 6, -1)[:2].any()


def test_pairlist_rejects_bad_shapes():
    ein = torch.zeros(8, 4)
    ids = torch.zeros(6, dtype=torch.int32)
    pm = torch.ones(6)
    with pytest.raises(ValueError, match="nb dividing"):
        pairlist_ns_grad(ein, ein, ids, None, ids,
                         torch.zeros((4, 2), dtype=torch.int32), pm, 1.0)
    with pytest.raises(ValueError, match="2W"):
        pairlist_ns_grad(ein, ein, ids.reshape(3, 2), torch.ones(3, 2),
                         ids, torch.zeros((3, 2), dtype=torch.int32), pm,
                         1.0)
    with pytest.raises(ValueError, match="one \\[B, L\\] shape"):
        pairlist_hs_grad(ein, ein, ids, None,
                         torch.zeros((6, 3), dtype=torch.int32),
                         torch.zeros((6, 2), dtype=torch.int32), pm, 1.0)


# -- host preparation: CompactBatch bit for bit --

def _config(cls, mode, **kw):
    args = dict(embedding_size=16, window=3, negative=5, epochs=2,
                min_count=1, sample=1e-2, init_learning_rate=0.025,
                batch_size=128, batch_group=4)
    args.update(MODES[mode])
    args.update(kw)
    return cls(**args)


def _batches(it, d, tok, mode, n, batch_size=128, seed=1):
    out = []
    for batch in it(d, tok, batch_size=batch_size, window=3,
                    subsample=1e-2, cbow="cbow" in mode, seed=seed):
        out.append(batch)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_prepare_is_bit_identical(tmp_path, mode):
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=120)
    jd = JDictionary.build(str(path), min_count=1)
    jtok = JTokenizedCorpus.build(jd, str(path))
    d = Dictionary.build(str(path), min_count=1)
    jmodel = JWord2Vec(_config(JConfig, mode, neg_block=8), jd)
    model = Word2Vec(_config(Word2VecConfig, mode, neg_block=8), d,
                     device="cpu")
    # Each package's own batch classes (the same arrays).
    pairs = list(zip(
        _batches(j_iter_pair_batches, jd, jtok, mode, 4),
        _batches(iter_pair_batches, d, TokenizedCorpus.build(d, str(path)),
                 mode, 4)))
    # An odd size: neg_block 8 falls back to the nearest divisor (4).
    c = np.arange(12, dtype=np.int32) % d.size
    odd = PairBatch(c, c[::-1].copy(), 10, 12.0)
    pairs.append((odd, odd))
    for jbatch, batch in pairs:
        want, got = jmodel.prepare(jbatch), model.prepare(batch)
        for name in ("rows_in", "rows_out", "rows_in_p", "rows_out_p",
                     "count", "words", "size"):
            w, g = getattr(want, name), getattr(got, name)
            np.testing.assert_array_equal(g, w, err_msg=name)
        for name in ("in_args", "out_args"):
            for w, g in zip(getattr(want, name), getattr(got, name)):
                assert g.dtype == w.dtype, name
                np.testing.assert_array_equal(g, w, err_msg=name)
    if not mode.startswith("hs"):
        assert got.out_args[1].shape == (3, 5)


# -- the local host-batch trainer vs the reference --

class JaxBatchDraws:
    """The reference's per-batch negatives (model.py:405-414): key
    ``fold_in(PRNGKey(seed), counter)`` split into the index and keep
    keys."""

    def __init__(self, seed):
        self._key = jax.random.PRNGKey(seed)

    def batch_draws(self, counter, shape, V):
        k_idx, k_keep = jax.random.split(
            jax.random.fold_in(self._key, counter))
        return (torch.from_numpy(np.array(
                    jax.random.randint(k_idx, shape, 0, V))),
                torch.from_numpy(np.array(
                    jax.random.uniform(k_keep, shape))))


@pytest.mark.parametrize("mode", list(MODES))
def test_local_train_batches_match_reference(tmp_path, mode):
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    jd = JDictionary.build(str(path), min_count=1)
    jtok = JTokenizedCorpus.build(jd, str(path))
    jmodel = JWord2Vec(_config(JConfig, mode), jd)
    init = (np.array(jmodel._emb_in), np.array(jmodel._emb_out))
    jbatches = _batches(j_iter_pair_batches, jd, jtok, mode, 10)
    assert jbatches[-1].count == 128
    want_loss, want_pairs = jmodel.train_batches(iter(jbatches))

    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    model = Word2Vec(_config(Word2VecConfig, mode), d, device="cpu",
                     draws=JaxBatchDraws(1))
    load_reference_embeddings(model, *init)
    got_loss, got_pairs = model.train_batches(iter(
        _batches(iter_pair_batches, d, tok, mode, 10)))
    assert got_pairs == want_pairs > 0
    np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL)
    assert model.trained_words == jmodel.trained_words
    assert model._batch_counter == jmodel._batch_counter == 10
    np.testing.assert_allclose(model._emb_in.numpy(),
                               np.asarray(jmodel._emb_in), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(model._emb_out.numpy(),
                               np.asarray(jmodel._emb_out), rtol=RTOL,
                               atol=ATOL)
    assert np.abs(model._emb_out.numpy()).max() > 0
    # One batch more through train_batch: the per-pair display loss.
    want = jmodel.train_batch(
        _batches(j_iter_pair_batches, jd, jtok, mode, 1, seed=9)[0])
    got = model.train_batch(_batches(iter_pair_batches, d, tok, mode, 1,
                                     seed=9)[0])
    np.testing.assert_allclose(got, want, rtol=RTOL)


# -- the PS host-batch trainer vs the reference --

def _ps_reference(path, mode, n):
    jd = JDictionary.build(str(path), min_count=1)
    jtok = JTokenizedCorpus.build(jd, str(path))
    jmv.init([])
    try:
        model = JPSWord2Vec(_config(JConfig, mode, use_ps=True), jd)
        loss, pairs = model.train_batches(iter(
            _batches(j_iter_pair_batches, jd, jtok, mode, n)))
        return (loss, pairs, model.trained_words, model._in_table.get(),
                model._out_table.get())
    finally:
        jmv.shutdown()


@pytest.mark.parametrize("mode", list(MODES))
def test_ps_train_batches_match_reference(tmp_path, mode):
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    want = _ps_reference(path, mode, 20)
    tmv.init([], device="cpu")
    try:
        model = PSWord2Vec(_config(Word2VecConfig, mode, use_ps=True), d)
        loss, pairs = model.train_batches(iter(
            _batches(iter_pair_batches, d, tok, mode, 20)))
        got_in, got_out = model._in_table.get(), model._out_table.get()
        trained = model.trained_words
    finally:
        tmv.shutdown()
    assert pairs == want[1] > 0
    np.testing.assert_allclose(loss, want[0], rtol=RTOL)
    assert trained == want[2]
    np.testing.assert_allclose(got_in, want[3], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_out, want[4], rtol=RTOL, atol=ATOL)
    assert np.abs(got_out).max() > 0


def test_ps_train_batch_and_loader(tmp_path):
    # train_batch drains its pushes; prepared() batches through the
    # loader thread train the same as raw batches.
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=120)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    results = []
    for loader in (False, True):
        tmv.init([], device="cpu")
        try:
            model = PSWord2Vec(_config(Word2VecConfig, "sgns",
                                       use_ps=True), d)
            batches = _batches(iter_pair_batches, d, tok, "sgns", 6)
            first = model.train_batch(batches[0])
            assert np.isfinite(first) and not model._pending_pushes
            rest = iter(batches[1:])
            loss, pairs = model.train_batches(
                BlockLoader(model.prepared(rest)) if loader else rest)
            results.append((first, loss, pairs, model._in_table.get()))
        finally:
            tmv.shutdown()
    assert results[0][:3] == results[1][:3]
    np.testing.assert_array_equal(results[0][3], results[1][3])


def test_local_trains_with_its_own_draws(tmp_path):
    # The port's own Philox negatives: falling loss over 3 epochs.
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    model = Word2Vec(Word2VecConfig(embedding_size=16, window=3, epochs=3,
                                    init_learning_rate=0.01, sample=0,
                                    batch_size=256, batch_group=4), d,
                     device="cpu")
    losses = []
    for epoch in range(3):
        loss, pairs = model.train_batches(iter_pair_batches(
            d, tok, batch_size=256, window=3, subsample=0, seed=epoch))
        losses.append(loss / pairs)
    assert losses[-1] < losses[0], losses
    assert model.trained_words == pytest.approx(3 * tok.flat.size)


# -- the CLI --

@pytest.mark.parametrize("flags", [
    [], ["-cbow=true", "-hs=true", "-negative=0"], ["-use_ps=true"],
    ["-use_ps=true", "-hs=true", "-negative=0", "-is_pipeline=false"]],
    ids=["local-sgns", "local-hs-cbow", "ps-sgns", "ps-hs-sg"])
def test_cli_host_batch_writes_vectors(tmp_path, flags):
    from multiverso_tpu_torch.models.wordembedding.main import run
    write_topic_corpus(tmp_path / "corpus.txt", n_sentences=100)
    out = tmp_path / "v.txt"
    model = run([f"-train_file={tmp_path / 'corpus.txt'}", "-min_count=1",
                 "-size=8", "-epoch=2", "-batch_size=256",
                 "-device_pipeline=false", f"-output_file={out}", *flags],
                device="cpu")
    assert isinstance(model, PSWord2Vec) == ("-use_ps=true" in flags)
    assert model.trained_words > 0
    lines = out.read_text().splitlines()
    assert lines[0] == f"{model.dictionary.size} 8"
    assert len(lines) == model.dictionary.size + 1
    word, *vec = lines[1].split()
    assert word == model.dictionary.words[0]
    assert np.isfinite([float(x) for x in vec]).all()


@pytest.mark.parametrize("flags", [[], ["-use_ps=true"]],
                         ids=["local", "ps"])
def test_cli_host_batch_defaults_to_the_card(tmp_path, flags):
    # Without device= the host-batch loop runs on cuda:0 and raises on a
    # host without a card: there is no CPU fallback.
    from multiverso_tpu_torch.models.wordembedding.main import run
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device works")
    write_topic_corpus(tmp_path / "corpus.txt", n_sentences=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        run([f"-train_file={tmp_path / 'corpus.txt'}", "-min_count=1",
             "-size=8", "-device_pipeline=false",
             f"-output_file={tmp_path / 'v.txt'}", *flags])
