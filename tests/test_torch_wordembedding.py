"""The whole slice: word2vec through the port's parameter server against
the JAX package's, on the small topic corpus.

Both packages' ``PSWord2Vec`` + ``PSDeviceCorpusTrainer`` train a few
blocks from identical tables (D=16, W=3, K=5, neg_block B=8, C=128
centers a block); the port replays the reference's ``jax.random`` draws
(the subsampling uniforms, the shrunk windows and the negatives, derived
exactly as ``device_train.py`` derives them), so its ids are the
reference's bit for bit and only float summation order differs. Per-block
losses and both tables' logical rows are compared with rtol=1e-5,
atol=1e-7: per-step differences are float32 reassociation (~1e-7
relative) and a few blocks of SGD compound them.

A second test trains the port alone with its own Philox draws and holds
it to the reference PS test's bar (falling loss, topic separation
> 0.3).
"""

import time

import jax
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.models.wordembedding import (
    Dictionary as JDictionary, PSDeviceCorpusTrainer as JTrainer,
    PSWord2Vec as JPSWord2Vec, TokenizedCorpus as JTokenizedCorpus,
    Word2VecConfig as JConfig)
from multiverso_tpu_torch.models.wordembedding import (
    Dictionary, PSDeviceCorpusTrainer, PSWord2Vec, TokenizedCorpus,
    Word2VecConfig, iter_pair_batches)
from multiverso_tpu_torch.models.wordembedding.convert import (
    load_reference_tables)

C, W, K, B, D = 128, 3, 5, 8, 16
BLOCKS = 6


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


def write_topic_corpus(path, n_sentences=800, seed=0):
    """Two topic clusters; words co-occur only within their topic (the
    corpus of tests/test_wordembedding.py)."""
    rng = np.random.default_rng(seed)
    topics = [[f"a{i}" for i in range(8)], [f"b{i}" for i in range(8)]]
    lines = []
    for _ in range(n_sentences):
        topic = topics[rng.integers(0, 2)]
        lines.append(" ".join(rng.choice(topic, size=12)))
    path.write_text("\n".join(lines))


def topic_separation(emb, dictionary):
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True),
                           1e-9)
    ids_a = [dictionary.word2id[w] for w in dictionary.words
             if w.startswith("a")]
    ids_b = [dictionary.word2id[w] for w in dictionary.words
             if w.startswith("b")]
    sims = emb @ emb.T
    within = (sims[np.ix_(ids_a, ids_a)].mean()
              + sims[np.ix_(ids_b, ids_b)].mean()) / 2
    return within - sims[np.ix_(ids_a, ids_b)].mean()


class JaxDraws:
    """Draw provider for the port's trainer that replays the reference's
    ``jax.random`` stream: ``PRNGKey(seed)`` split into (key, prep_key);
    the subsampling uniforms from prep_key; per block
    ``fold_in(key, block)`` split three ways into the shrink, negative
    index and negative keep keys (device_train.py:1086-1105, 703-722)."""

    def epoch_uniforms(self, seed, n_tokens):
        key, prep_key = jax.random.split(jax.random.PRNGKey(seed))
        self._key = key
        return torch.from_numpy(np.array(
            jax.random.uniform(prep_key, (n_tokens,))))

    def group_draws(self, seed, block, G, C, W, neg_shape, V):
        assert G == 1 and neg_shape is not None
        step_key = jax.random.fold_in(self._key, block)
        k_shrink, k_idx, k_keep = jax.random.split(step_key, 3)
        draws = (jax.random.randint(k_shrink, (C,), 1, W + 1),
                 jax.random.randint(k_idx, neg_shape, 0, V),
                 jax.random.uniform(k_keep, neg_shape))
        return [tuple(torch.from_numpy(np.array(x)) for x in draws)]


def _config(cls, **kw):
    return cls(embedding_size=D, window=W, negative=K, epochs=2,
               min_count=1, sample=1e-2, init_learning_rate=0.025,
               use_ps=True, neg_block=B, **kw)


def _train_reference(path, seed):
    d = JDictionary.build(str(path), min_count=1)
    tok = JTokenizedCorpus.build(d, str(path))
    jmv.init([])
    try:
        model = JPSWord2Vec(_config(JConfig), d)
        init = (model._in_table.get().copy(), model._out_table.get().copy())
        trainer = JTrainer(model, tok, centers_per_step=C)
        losses = []
        trainer.train_epoch(
            seed=seed, max_steps=BLOCKS,
            block_hook=lambda _w: losses.append(float(trainer.last_loss)))
        model._drain_pushes()
        return (init, losses, model._in_table.get().copy(),
                model._out_table.get().copy(), model.trained_words)
    finally:
        jmv.shutdown()


def test_slice_matches_reference(tmp_path):
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    seed = 3
    init, want_losses, want_in, want_out, want_words = _train_reference(
        path, seed)

    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    tmv.init([], device="cpu")
    try:
        model = PSWord2Vec(_config(Word2VecConfig), d)
        # The server-side random init is the reference's numpy draw.
        np.testing.assert_array_equal(model._in_table.get(), init[0])
        load_reference_tables(model, *init)
        trainer = PSDeviceCorpusTrainer(model, tok, centers_per_step=C,
                                        draws=JaxDraws())
        losses = []
        trainer.train_epoch(
            seed=seed, max_steps=BLOCKS,
            block_hook=lambda _w: losses.append(float(trainer.last_loss)))
        got_in = model._in_table.get()
        got_out = model._out_table.get()
        assert model.trained_words == want_words
    finally:
        tmv.shutdown()
    assert len(losses) == len(want_losses) == BLOCKS
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_in, want_in, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-7)
    assert np.abs(got_out).max() > 0   # the blocks really trained


def test_port_trains_with_its_own_draws(tmp_path):
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    tmv.init([], device="cpu")
    try:
        config = Word2VecConfig(embedding_size=16, window=3, epochs=3,
                                init_learning_rate=0.01, batch_size=1024,
                                sample=0)
        model = PSWord2Vec(config, d)
        trainer = PSDeviceCorpusTrainer(model, tok, centers_per_step=128)
        losses = []
        for epoch in range(3):
            loss, pairs = trainer.train_epoch(seed=epoch)
            assert pairs > 0
            losses.append(loss / pairs)
        assert losses[-1] < losses[0], losses
        sep = topic_separation(model.embeddings, d)
        assert sep > 0.3, f"separation {sep}"
    finally:
        tmv.shutdown()


def test_unported_modes_raise(tmp_path):
    # CBOW, HS, per-pair and G > 1 run now (tests/test_torch_ps_modes.py),
    # segmented keys on one server are a no-op as in the reference (they
    # run over several: tests/test_torch_segmented.py), and the host-batch
    # step's host-buffer arm trains (tests/test_torch_client_cache.py
    # holds it against the device arm and the reference).
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=50)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    tmv.init([], device="cpu")
    try:
        model = PSWord2Vec(Word2VecConfig(embedding_size=8, cbow=True), d)
        PSDeviceCorpusTrainer(model, tok, centers_per_step=16,
                              blocks_per_dispatch=4)
        trainer = PSDeviceCorpusTrainer(model, tok, centers_per_step=16,
                                        segment_keys=True)
        assert not trainer._segment_keys and trainer._seg_ids is None
        model._device_path = False
        loss, pairs = model.train_batches(iter([model.prepare(next(
            iter_pair_batches(d, tok, batch_size=64, window=3,
                              cbow=True)))]))
        assert np.isfinite(loss) and pairs > 0
    finally:
        tmv.shutdown()
