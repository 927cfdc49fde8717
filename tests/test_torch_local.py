"""The local word2vec pipeline of the port against the JAX package's.

- K5-K8's plain versions (the wrappers on CPU tensors) against the JAX
  objectives they replace: ``_banded_cbow_loss_and_grads``,
  ``_hs_sg_loss_and_grads``, ``_hs_cbow_loss_and_grads`` and
  ``_pair_offset_loss_and_grads``, with rows large enough that some
  logits pass +-6, centers with no valid context and Huffman paths
  padded with -1. Tolerance rtol=1e-5, atol=1e-6, as K4's: float32 sums
  of the same terms taken in another order. An exact-tie case for each
  kernel: a zero output table (every logit exactly 0, where JAX's
  gradient is -y) and logits of exactly +-6 (half the clip gradient).
- The trainer in all five modes (SGNS, CBOW, HS skip-gram, HS CBOW,
  per-pair) against the JAX ``Word2Vec`` + ``DeviceCorpusTrainer`` from
  identical tables with the reference's ``jax.random`` draws replayed
  (C=128, G=4, 6 steps on the topic corpus): epoch loss and examples,
  the word accounting and both tables, rtol=1e-5, atol=1e-7 — the ids
  are the reference's bit for bit and only float summation order
  differs.
- Each mode trained with the port's own draws, held to the reference's
  bars (tests/test_wordembedding.py): falling loss, topic separation
  > 0.3; the reference's accounting tests (``max_steps``, the
  ``group_hook`` word sums, subsample counts); the CLI's local branch and
  ``-stopwords``; the card as the default device.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models.wordembedding import (
    DeviceCorpusTrainer as JTrainer, Dictionary as JDictionary,
    TokenizedCorpus as JTokenizedCorpus, Word2Vec as JWord2Vec,
    Word2VecConfig as JConfig)
from multiverso_tpu.models.wordembedding import device_train as jdt
from multiverso_tpu_torch.kernels import (banded_cbow_grad,
                                          banded_hs_sg_grad, hs_cbow_grad,
                                          pair_offset_grad)
from multiverso_tpu_torch.kernels.cbow import window_mean
from multiverso_tpu_torch.kernels.objective import offsets
from multiverso_tpu_torch.models.wordembedding import (
    DeviceCorpusTrainer, Dictionary, TokenizedCorpus, Word2Vec,
    Word2VecConfig)
from multiverso_tpu_torch.models.wordembedding.convert import (
    load_reference_embeddings)

RTOL, ATOL = 1e-5, 1e-6          # kernels vs the JAX objectives
SCALE = np.float32(-0.025)       # -lr


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


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _pmask(rng, C, W):
    pmask = (rng.random((C, 2 * W)) < 0.7).astype(np.float32)
    pmask[:3] = 0.0                       # centers with no valid context
    return pmask


def _some_clipped(logits):
    """The inputs reach both sides of the clip bound."""
    logits = np.abs(np.asarray(logits))
    assert (logits > 6).any() and (logits < 6).any()


def _paths(rng, n, L, inner):
    """Huffman-like paths: 1..L real nodes, then -1 padding in both."""
    path = np.full((n, L), -1, np.int32)
    code = np.full((n, L), -1, np.int32)
    for i, length in enumerate(rng.integers(1, L + 1, n)):
        path[i, :length] = rng.integers(0, inner, length)
        code[i, :length] = rng.integers(0, 2, length)
    return path, code


# -- K5-K8 plain versions vs the JAX objectives --

@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("W", [1, 3, 5])
def test_banded_cbow_grad_matches_jax(W, B):
    rng = np.random.default_rng(10 * W + B)
    C, K, D = 64, 5, 16
    nb = C // B
    u_band = (rng.standard_normal((C + 2 * W, D)) * 2.0).astype(np.float32)
    u_out = (rng.standard_normal((C + nb * K, D)) * 2.0).astype(np.float32)
    pmask = _pmask(rng, C, W)
    loss, g_band, g_center, g_neg, ex = jdt._banded_cbow_loss_and_grads(
        jnp.asarray(u_band), jnp.asarray(u_out[:C]),
        jnp.asarray(u_out[C:].reshape(nb, K, D)), jnp.asarray(pmask))
    got = banded_cbow_grad(_t(u_band), _t(u_out), _t(pmask), W, K, B,
                           float(SCALE))
    vmean = window_mean(_t(u_band), _t(pmask), W)[0].numpy()
    _some_clipped((vmean * u_out[:C]).sum(-1)[pmask.sum(1) > 0])
    _close(got[0], SCALE * np.asarray(g_band))
    _close(got[1], SCALE * np.concatenate(
        [np.asarray(g_center), np.asarray(g_neg).reshape(nb * K, D)]))
    _close(got[2], loss)
    assert float(got[3]) == float(ex) == float((pmask.sum(1) > 0).sum())


@pytest.mark.parametrize("W", [1, 3, 5])
def test_banded_hs_sg_grad_matches_jax(W):
    rng = np.random.default_rng(20 + W)
    C, L, D = 48, 6, 16
    v = (rng.standard_normal((C, D)) * 0.9).astype(np.float32)
    u_bp = (rng.standard_normal(((C + 2 * W) * L, D)) * 0.9).astype(
        np.float32)
    path_band, code_band = _paths(rng, C + 2 * W, L, 30)
    pmask = _pmask(rng, C, W)
    loss, g_v, g_bp = jdt._hs_sg_loss_and_grads(
        jnp.asarray(v), jnp.asarray(u_bp.reshape(C + 2 * W, L, D)),
        jnp.asarray(path_band), jnp.asarray(code_band), jnp.asarray(pmask))
    got = banded_hs_sg_grad(_t(v), _t(u_bp), _t(path_band), _t(code_band),
                            _t(pmask), W, float(SCALE))
    u3 = u_bp.reshape(C + 2 * W, L, D)
    _some_clipped(np.concatenate(
        [np.einsum("cd,cld->cl", v, u3[W + o:W + o + C])[
            (pmask[:, j] > 0)[:, None] & (path_band[W + o:W + o + C] >= 0)]
         for j, o in enumerate(offsets(W))]))
    _close(got[0], SCALE * np.asarray(g_v))
    _close(got[1], SCALE * np.asarray(g_bp).reshape(-1, D))
    _close(got[2], loss)
    assert float(got[3]) == float(pmask.sum())
    # Padded nodes get exactly zero gradient (their rows scatter into
    # row 0 and must add nothing).
    pad = (path_band < 0).reshape(-1)
    assert not got[1].numpy()[pad].any()


@pytest.mark.parametrize("W", [1, 3, 5])
def test_hs_cbow_grad_matches_jax(W):
    rng = np.random.default_rng(30 + W)
    C, L, D = 48, 6, 16
    u_band = (rng.standard_normal((C + 2 * W, D)) * 2.0).astype(np.float32)
    u_path = (rng.standard_normal((C * L, D)) * 2.0).astype(np.float32)
    path, code = _paths(rng, C, L, 30)
    pmask = _pmask(rng, C, W)
    loss, g_band, g_path, ex = jdt._hs_cbow_loss_and_grads(
        jnp.asarray(u_band), jnp.asarray(u_path.reshape(C, L, D)),
        jnp.asarray(path), jnp.asarray(code), jnp.asarray(pmask))
    got = hs_cbow_grad(_t(u_band), _t(u_path), _t(path), _t(code),
                       _t(pmask), W, float(SCALE))
    vmean = window_mean(_t(u_band), _t(pmask), W)[0].numpy()
    _some_clipped(np.einsum("cd,cld->cl", vmean, u_path.reshape(C, L, D))[
        (pmask.sum(1) > 0)[:, None] & (path >= 0)])
    _close(got[0], SCALE * np.asarray(g_band))
    _close(got[1], SCALE * np.asarray(g_path).reshape(-1, D))
    _close(got[2], loss)
    assert float(got[3]) == float(ex)
    no_ctx = np.repeat(pmask.sum(1) == 0, L) | (path < 0).reshape(-1)
    assert not got[1].numpy()[no_ctx].any()


@pytest.mark.parametrize("C,K", [(64, 5), (33, 3), (8, 1)])
def test_pair_offset_grad_matches_jax(C, K):
    rng = np.random.default_rng(C + K)
    D = 16
    v = (rng.standard_normal((C, D)) * 1.5).astype(np.float32)
    u = (rng.standard_normal((C + C * K, D)) * 1.5).astype(np.float32)
    m = (rng.random(C) < 0.7).astype(np.float32)
    m[:2] = 0.0
    loss, g_v, g_pos, g_neg = jdt._pair_offset_loss_and_grads(
        jnp.asarray(v), jnp.asarray(u[:C]),
        jnp.asarray(u[C:].reshape(C, K, D)), jnp.asarray(m))
    got = pair_offset_grad(_t(v), _t(u), _t(m), K, float(SCALE))
    rows = np.concatenate([u[:C, None], u[C:].reshape(C, K, D)], axis=1)
    _some_clipped(np.einsum("cd,ckd->ck", v, rows)[m > 0])
    _close(got[0], SCALE * np.asarray(g_v))
    _close(got[1], SCALE * np.concatenate(
        [np.asarray(g_pos), np.asarray(g_neg).reshape(C * K, D)]))
    _close(got[2], loss)
    assert float(got[3]) == m.sum()    # examples: the valid pairs


def _tie_rows(n, D, value):
    """Rows whose dot products with ``_tie_out`` rows are exactly
    +-value: first column ``value``, the rest zero."""
    rows = np.zeros((n, D), np.float32)
    rows[:, 0] = value
    return rows


def _tie_out(n, D, zero):
    rows = np.zeros((n, D), np.float32)
    if not zero:
        rows[::2, 0] = 1.0
        rows[1::2, 0] = -1.0
    return rows


@pytest.mark.parametrize("zero_out", [True, False],
                         ids=["logits-0", "logits-6"])
@pytest.mark.parametrize("kernel", ["cbow", "hs_sg", "hs_cbow", "pair"])
def test_exact_ties_match_jax(kernel, zero_out):
    # A zero output table makes every logit exactly 0, where JAX's
    # gradient is -y (not sigmoid(0) - y); rows of +-6 make logits of
    # exactly +-6, where the clip gradient splits in halves.
    rng = np.random.default_rng(5)
    C, W, K, L, D = 16, 2, 3, 4, 8
    pmask = np.ones((C, 2 * W), np.float32)
    pmask[0] = 0.0
    s = float(SCALE)
    if kernel == "cbow":
        B = 4
        nb = C // B
        u_band = _tie_rows(C + 2 * W, D, 6.0)
        u_out = _tie_out(C + nb * K, D, zero_out)
        want = jdt._banded_cbow_loss_and_grads(
            jnp.asarray(u_band), jnp.asarray(u_out[:C]),
            jnp.asarray(u_out[C:].reshape(nb, K, D)), jnp.asarray(pmask))
        got = banded_cbow_grad(_t(u_band), _t(u_out), _t(pmask), W, K, B,
                               s)
        pairs = [(got[0], SCALE * np.asarray(want[1])),
                 (got[1], SCALE * np.concatenate(
                     [np.asarray(want[2]),
                      np.asarray(want[3]).reshape(-1, D)])),
                 (got[2], want[0])]
    elif kernel == "hs_sg":
        v = _tie_rows(C, D, 6.0)
        u_bp = _tie_out((C + 2 * W) * L, D, zero_out)
        path, code = _paths(rng, C + 2 * W, L, 10)
        want = jdt._hs_sg_loss_and_grads(
            jnp.asarray(v), jnp.asarray(u_bp.reshape(C + 2 * W, L, D)),
            jnp.asarray(path), jnp.asarray(code), jnp.asarray(pmask))
        got = banded_hs_sg_grad(_t(v), _t(u_bp), _t(path), _t(code),
                                _t(pmask), W, s)
        pairs = [(got[0], SCALE * np.asarray(want[1])),
                 (got[1], SCALE * np.asarray(want[2]).reshape(-1, D)),
                 (got[2], want[0])]
    elif kernel == "hs_cbow":
        u_band = _tie_rows(C + 2 * W, D, 6.0)
        u_path = _tie_out(C * L, D, zero_out)
        path, code = _paths(rng, C, L, 10)
        want = jdt._hs_cbow_loss_and_grads(
            jnp.asarray(u_band), jnp.asarray(u_path.reshape(C, L, D)),
            jnp.asarray(path), jnp.asarray(code), jnp.asarray(pmask))
        got = hs_cbow_grad(_t(u_band), _t(u_path), _t(path), _t(code),
                           _t(pmask), W, s)
        pairs = [(got[0], SCALE * np.asarray(want[1])),
                 (got[1], SCALE * np.asarray(want[2]).reshape(-1, D)),
                 (got[2], want[0])]
    else:
        v = _tie_rows(C, D, 6.0)
        u = _tie_out(C + C * K, D, zero_out)
        m = pmask[:, 0].copy()
        want = jdt._pair_offset_loss_and_grads(
            jnp.asarray(v), jnp.asarray(u[:C]),
            jnp.asarray(u[C:].reshape(C, K, D)), jnp.asarray(m))
        got = pair_offset_grad(_t(v), _t(u), _t(m), K, s)
        pairs = [(got[0], SCALE * np.asarray(want[1])),
                 (got[1], SCALE * np.concatenate(
                     [np.asarray(want[2]),
                      np.asarray(want[3]).reshape(-1, D)])),
                 (got[2], want[0])]
    for g, w in pairs:
        _close(g, w)
    # The ties carry gradient (into the output rows at least).
    assert max(np.abs(w).max() for _, w in pairs[:2]) > 0


# -- the trainer against the reference --

C, G, STEPS, D = 128, 4, 6, 16

MODES = {
    "sgns": dict(neg_block=8),
    "cbow": dict(cbow=True, neg_block=8),
    "hs_sg": dict(hs=True, negative=0),
    "hs_cbow": dict(hs=True, cbow=True, negative=0),
    "per_pair": dict(per_pair=True),
}


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


class JaxStepDraws:
    """Draw provider for the port's local trainer that replays the
    reference's ``jax.random`` stream (device_train.py:584-627 and
    ``_make_group`` :288-313): ``PRNGKey(seed)`` split into (key,
    prep_key), the subsampling uniforms from prep_key; per step
    ``key, sub = split(key)``; SGNS, CBOW and per-pair split ``sub``
    three ways into the shrink, negative index and keep keys; HS splits
    it two ways and draws the shrink only."""

    def epoch_uniforms(self, seed, n_tokens):
        key, prep_key = jax.random.split(jax.random.PRNGKey(seed))
        self._key, self._next = key, 0
        return _t(jax.random.uniform(prep_key, (n_tokens,)))

    def step_draws(self, seed, step, C, W, neg_shape, V):
        assert step == self._next, (step, self._next)
        self._next += 1
        self._key, sub = jax.random.split(self._key)
        if neg_shape is None:
            k_shrink, _ = jax.random.split(sub)
            return (_t(jax.random.randint(k_shrink, (C,), 1, W + 1)), None,
                    None)
        k_shrink, k_idx, k_keep = jax.random.split(sub, 3)
        return (_t(jax.random.randint(k_shrink, (C,), 1, W + 1)),
                _t(jax.random.randint(k_idx, neg_shape, 0, V)),
                _t(jax.random.uniform(k_keep, neg_shape)))


def _config(cls, mode):
    kw = dict(embedding_size=D, window=3, negative=5, epochs=2,
              min_count=1, sample=1e-2, init_learning_rate=0.025)
    kw.update(MODES[mode])
    return cls(**kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_trainer_matches_reference(tmp_path, mode):
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    seed = 3
    jd = JDictionary.build(str(path), min_count=1)
    jmodel = JWord2Vec(_config(JConfig, mode), jd)
    init = (np.array(jmodel._emb_in), np.array(jmodel._emb_out))
    jtrainer = JTrainer(jmodel, JTokenizedCorpus.build(jd, str(path)),
                        centers_per_step=C, steps_per_dispatch=G)
    want_loss, want_ex = jtrainer.train_epoch(seed=seed, max_steps=STEPS)

    d = Dictionary.build(str(path), min_count=1)
    model = Word2Vec(_config(Word2VecConfig, mode), d, device="cpu")
    if model.config.hs:
        np.testing.assert_array_equal(model._points_host,
                                      jmodel._points_host)
    load_reference_embeddings(model, *init)
    trainer = DeviceCorpusTrainer(model, TokenizedCorpus.build(d, str(path)),
                                  centers_per_step=C, steps_per_dispatch=G,
                                  draws=JaxStepDraws())
    hooks = []
    got_loss, got_ex = trainer.train_epoch(seed=seed, max_steps=STEPS,
                                           group_hook=hooks.append)
    assert trainer._draws._next == STEPS
    assert len(hooks) == 2
    assert got_ex == want_ex > 0
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert model.trained_words == jmodel.trained_words
    assert trainer.kept_words_trained == jtrainer.kept_words_trained
    np.testing.assert_allclose(model._emb_in.numpy(),
                               np.asarray(jmodel._emb_in), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(model._emb_out.numpy(),
                               np.asarray(jmodel._emb_out), rtol=1e-5,
                               atol=1e-7)
    assert np.abs(model._emb_out.numpy()).max() > 0   # it really trained


LR = {"sgns": 0.01, "cbow": 0.02, "hs_sg": 0.02, "hs_cbow": 0.04,
      "per_pair": 0.01}


@pytest.mark.parametrize("mode", list(MODES))
def test_trains_with_its_own_draws(tmp_path, mode):
    # The reference's local-pipeline bars (tests/test_wordembedding.py
    # TestDeviceCorpusTrainer): falling loss, topic separation > 0.3.
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    kw = dict(MODES[mode])
    kw.pop("neg_block", None)
    config = Word2VecConfig(embedding_size=16, window=3, epochs=3,
                            init_learning_rate=LR[mode], batch_size=1024,
                            sample=0, **kw)
    model = Word2Vec(config, d, device="cpu")
    trainer = DeviceCorpusTrainer(model, tok, centers_per_step=128,
                                  steps_per_dispatch=4)
    losses = []
    for epoch in range(3):
        loss, examples = trainer.train_epoch(seed=epoch)
        assert examples > 0
        losses.append(loss / examples)
    assert losses[-1] < losses[0], losses
    sep = topic_separation(model.embeddings, d)
    assert sep > 0.3, f"separation {sep}"
    assert model.trained_words == pytest.approx(3 * tok.flat.size)


def _small(tmp_path, n_sentences=100):
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=n_sentences)
    d = Dictionary.build(str(path), min_count=1)
    return d, TokenizedCorpus.build(d, str(path))


def test_subsample_counts(tmp_path):
    # With aggressive subsampling the trained pair count must drop but
    # raw-word accounting (the lr clock) must still cover the whole
    # corpus (ref: reader.cpp counts discarded words too).
    d, tok = _small(tmp_path, 800)
    pair_counts = {}
    for sample in (0, 1e-4):
        config = Word2VecConfig(embedding_size=8, window=3, epochs=1,
                                batch_size=256, sample=sample)
        model = Word2Vec(config, d, device="cpu")
        trainer = DeviceCorpusTrainer(model, tok, centers_per_step=128,
                                      steps_per_dispatch=2)
        _, pairs = trainer.train_epoch(seed=0)
        pair_counts[sample] = pairs
        assert model.trained_words == pytest.approx(tok.flat.size)
    assert pair_counts[1e-4] < 0.7 * pair_counts[0]


def test_max_steps_and_accounting(tmp_path):
    d, tok = _small(tmp_path)
    model = Word2Vec(Word2VecConfig(embedding_size=8, window=2, epochs=1,
                                    batch_size=128, sample=0), d,
                     device="cpu")
    trainer = DeviceCorpusTrainer(model, tok, centers_per_step=64,
                                  steps_per_dispatch=4)
    # A truncated (warmup-style) epoch trains only max_steps steps.
    _, pairs = trainer.train_epoch(seed=0, max_steps=2)
    assert 0 < pairs < tok.flat.size * 4
    assert trainer.kept_words_trained == 2 * 64
    assert 0 < model.trained_words < tok.flat.size


def test_group_hook_words_sum(tmp_path):
    d, tok = _small(tmp_path)
    model = Word2Vec(Word2VecConfig(embedding_size=8, window=2, epochs=1,
                                    batch_size=128, sample=0), d,
                     device="cpu")
    trainer = DeviceCorpusTrainer(model, tok, centers_per_step=64,
                                  steps_per_dispatch=4)
    seen = []
    trainer.train_epoch(seed=0, group_hook=seen.append)
    # One call per group of 4 steps; the words sum to exactly the
    # epoch's raw words (the words/s denominators depend on it).
    assert len(seen) == -(-tok.flat.size // (64 * 4))
    assert sum(seen) == pytest.approx(tok.flat.size)
    assert model.trained_words == pytest.approx(tok.flat.size)


def test_trainer_rejects_bad_modes(tmp_path):
    d, tok = _small(tmp_path, 20)
    model = Word2Vec(Word2VecConfig(embedding_size=8, cbow=True,
                                    per_pair=True), d, device="cpu")
    with pytest.raises(ValueError, match="skip-gram"):
        DeviceCorpusTrainer(model, tok, centers_per_step=16)
    model = Word2Vec(Word2VecConfig(embedding_size=8, neg_block=3), d,
                     device="cpu")
    with pytest.raises(ValueError, match="neg_block"):
        DeviceCorpusTrainer(model, tok, centers_per_step=16)
    # The host-batch loop runs (it raised before its port): an empty
    # stream trains nothing.
    assert model.train_batches(iter([])) == (0.0, 0)


def test_the_card_is_the_default_device(tmp_path):
    from multiverso_tpu_torch.models.wordembedding.main import run
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device works")
    d, _ = _small(tmp_path, 20)
    with pytest.raises(RuntimeError, match="CUDA"):
        Word2Vec(Word2VecConfig(embedding_size=8), d)
    with pytest.raises(RuntimeError, match="CUDA"):
        run([f"-train_file={tmp_path / 'corpus.txt'}", "-min_count=1",
             "-size=8", f"-output_file={tmp_path / 'v.txt'}"])


@pytest.mark.parametrize("flags", [[], ["-cbow=true", "-hs=true",
                                        "-negative=0"]])
def test_cli_local_branch_writes_vectors(tmp_path, flags):
    from multiverso_tpu_torch.models.wordembedding.main import run
    write_topic_corpus(tmp_path / "corpus.txt", n_sentences=200)
    out = tmp_path / "v.txt"
    model = run([f"-train_file={tmp_path / 'corpus.txt'}", "-min_count=1",
                 "-size=8", "-epoch=2", f"-output_file={out}", *flags],
                device="cpu")
    assert isinstance(model, Word2Vec) and model.trained_words > 0
    lines = out.read_text().splitlines()
    assert lines[0] == f"{model.dictionary.size} 8"
    assert len(lines) == model.dictionary.size + 1
    word, *vec = lines[1].split()
    assert word == model.dictionary.words[0]
    np.testing.assert_allclose([float(x) for x in vec],
                               model.embeddings[0], atol=1e-6)


def test_cli_stopwords_filtered(tmp_path):
    # ref: Applications/WordEmbedding/src/reader.cpp — the -stopwords
    # table drops listed words before training.
    from multiverso_tpu_torch.models.wordembedding.main import run
    corpus = tmp_path / "c.txt"
    corpus.write_text("the a0 the a1 the a2 a0 a1\n"
                      "the a1 a2 the a0 a2 a1 a0\n" * 10)
    stop = tmp_path / "stop.txt"
    stop.write_text("the\n")
    model = run([f"-train_file={corpus}", f"-stopwords={stop}",
                 "-min_count=1", "-size=8", "-epoch=1",
                 f"-output_file={tmp_path / 'v.txt'}"], device="cpu")
    assert "the" not in model.dictionary.word2id
    assert "a0" in model.dictionary.word2id
