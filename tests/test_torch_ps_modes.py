"""The PS device pipeline's other modes against the JAX package's.

Both packages' ``PSWord2Vec`` + ``PSDeviceCorpusTrainer`` train a few
blocks (dispatch groups) on the topic corpus from identical tables: CBOW
(K5), HS skip-gram (K6), HS CBOW (K7), the per-pair quality mode (2W K8
sub-steps on local copies of the pulled rows) and skip-gram with
negative sampling at G=2 blocks a dispatch (K4). The port replays the
reference's ``jax.random`` draws — per dispatch ``fold_in(key, g0)``,
split G ways when G > 1, then three ways (shrink, negative index, keep;
two for HS) per block — so its ids are the reference's bit for bit and
only float summation order differs. Per-group losses, the examples, the
word accounting and both tables are compared at rtol 1e-5 / atol 1e-7.
Segmented keys (B11) on one server are a no-op, as in the reference,
and the CLI takes ``-use_ps=true`` with ``-hs=true``.
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
    Word2VecConfig)
from multiverso_tpu_torch.models.wordembedding.convert import (
    load_reference_tables)

RTOL, ATOL = 1e-5, 1e-7

# mode: (config flags, centers a block, blocks a dispatch, blocks run)
MODES = {
    "cbow": (dict(cbow=True, neg_block=8), 128, 1, 5),
    "hs_sg": (dict(hs=True, negative=0), 128, 1, 5),
    "hs_cbow": (dict(hs=True, cbow=True, negative=0), 128, 1, 5),
    "per_pair": (dict(per_pair=True), 64, 1, 5),
    "sgns_g2": (dict(neg_block=8), 128, 2, 5),
    "per_pair_g2": (dict(per_pair=True), 64, 2, 4),
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


def write_topic_corpus(path, n_sentences=400, seed=0):
    """Two topic clusters; words co-occur only within their topic (the
    corpus of tests/test_wordembedding.py)."""
    rng = np.random.default_rng(seed)
    topics = [[f"a{i}" for i in range(8)], [f"b{i}" for i in range(8)]]
    lines = []
    for _ in range(n_sentences):
        topic = topics[rng.integers(0, 2)]
        lines.append(" ".join(rng.choice(topic, size=12)))
    path.write_text("\n".join(lines))


def _t(x):
    return torch.from_numpy(np.array(x))


class JaxGroupDraws:
    """Replays the reference PS trainer's ``jax.random`` stream
    (device_train.py:1060-1105, 643-722, 792-806): ``PRNGKey(seed)``
    split into (key, prep_key), the subsampling uniforms from prep_key;
    per dispatch ``fold_in(key, g0)``, split G ways when G > 1; each
    block's key split three ways (shrink, negative index, keep), or two
    for hierarchical softmax (the shrink only)."""

    def epoch_uniforms(self, seed, n_tokens):
        key, prep_key = jax.random.split(jax.random.PRNGKey(seed))
        self._key = key
        return _t(jax.random.uniform(prep_key, (n_tokens,)))

    def group_draws(self, seed, block, G, C, W, neg_shape, V):
        step_key = jax.random.fold_in(self._key, block)
        keys = [step_key] if G == 1 else list(jax.random.split(step_key, G))
        out = []
        for key in keys:
            if neg_shape is None:
                k_shrink, _ = jax.random.split(key)
                out.append((_t(jax.random.randint(k_shrink, (C,), 1, W + 1)),
                            None, None))
                continue
            k_shrink, k_idx, k_keep = jax.random.split(key, 3)
            out.append((_t(jax.random.randint(k_shrink, (C,), 1, W + 1)),
                        _t(jax.random.randint(k_idx, neg_shape, 0, V)),
                        _t(jax.random.uniform(k_keep, neg_shape))))
        return out


def _config(cls, flags):
    kw = dict(embedding_size=16, window=3, negative=5, epochs=2,
              min_count=1, sample=1e-2, init_learning_rate=0.025,
              use_ps=True)
    kw.update(flags)
    return cls(**kw)


def _train_reference(path, flags, C, G, blocks, seed):
    d = JDictionary.build(str(path), min_count=1)
    tok = JTokenizedCorpus.build(d, str(path))
    jmv.init([])
    try:
        model = JPSWord2Vec(_config(JConfig, flags), d)
        init = (model._in_table.get().copy(), model._out_table.get().copy())
        trainer = JTrainer(model, tok, centers_per_step=C,
                           blocks_per_dispatch=G)
        losses = []
        loss, examples = trainer.train_epoch(
            seed=seed, max_steps=blocks,
            block_hook=lambda _w: losses.append(float(trainer.last_loss)))
        model._drain_pushes()
        return (init, losses, loss, examples, model._in_table.get().copy(),
                model._out_table.get().copy(), model.trained_words,
                trainer.kept_words_trained)
    finally:
        jmv.shutdown()


@pytest.mark.parametrize("mode", list(MODES))
def test_ps_mode_matches_reference(tmp_path, mode):
    flags, C, G, blocks = MODES[mode]
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    seed = 3
    (init, want_losses, want_loss, want_ex, want_in, want_out, want_words,
     want_kept) = _train_reference(path, flags, C, G, blocks, seed)

    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    tmv.init([], device="cpu")
    try:
        model = PSWord2Vec(_config(Word2VecConfig, flags), d)
        load_reference_tables(model, *init)
        trainer = PSDeviceCorpusTrainer(model, tok, centers_per_step=C,
                                        blocks_per_dispatch=G,
                                        draws=JaxGroupDraws())
        losses = []
        loss, examples = trainer.train_epoch(
            seed=seed, max_steps=blocks,
            block_hook=lambda _w: losses.append(float(trainer.last_loss)))
        got_in = model._in_table.get()
        got_out = model._out_table.get()
        assert model.trained_words == want_words
        assert trainer.kept_words_trained == want_kept
    finally:
        tmv.shutdown()
    assert len(losses) == len(want_losses) == -(-blocks // G)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    assert examples == want_ex > 0
    np.testing.assert_allclose(got_in, want_in, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_out, want_out, rtol=RTOL, atol=ATOL)
    assert np.abs(got_out).max() > 0   # the blocks really trained


@pytest.mark.parametrize("mode", ["cbow", "hs_sg", "per_pair"])
def test_ps_mode_trains_with_its_own_draws(tmp_path, mode):
    # The port's own Philox draws: falling loss over 3 epochs, at lr
    # 0.01 (at 0.025 and G=2 HS skip-gram diverges on this 16-word
    # corpus in the reference too: every block's paths share the root).
    flags, C, G, _ = MODES[mode]
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    tmv.init([], device="cpu")
    try:
        model = PSWord2Vec(_config(Word2VecConfig, {
            **flags, "epochs": 3, "sample": 0,
            "init_learning_rate": 0.01}), d)
        trainer = PSDeviceCorpusTrainer(model, tok, centers_per_step=C,
                                        blocks_per_dispatch=2)
        losses = []
        for epoch in range(3):
            loss, examples = trainer.train_epoch(seed=epoch)
            assert examples > 0
            losses.append(loss / examples)
        assert losses[-1] < losses[0], losses
    finally:
        tmv.shutdown()


def test_segment_keys_still_raise(tmp_path):
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=50)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    tmv.init([], device="cpu")
    try:
        model = PSWord2Vec(Word2VecConfig(embedding_size=8, hs=True), d)
        # One server: segmented keys are a no-op, as in the reference
        # (device_train.py:1035); they run over several servers
        # (tests/test_torch_segmented.py).
        trainer = PSDeviceCorpusTrainer(model, tok, centers_per_step=16,
                                        segment_keys=True)
        assert not trainer._segment_keys and trainer._seg_ids is None
        model = PSWord2Vec(Word2VecConfig(embedding_size=8, cbow=True,
                                          per_pair=True), d)
        with pytest.raises(ValueError, match="skip-gram"):
            PSDeviceCorpusTrainer(model, tok, centers_per_step=16)
    finally:
        tmv.shutdown()


@pytest.mark.parametrize("flags", [["-hs=true", "-negative=0"],
                                   ["-cbow=true", "-neg_block=4"],
                                   ["-per_pair=true"]])
def test_cli_ps_modes(tmp_path, flags):
    from multiverso_tpu_torch.models.wordembedding.main import run
    write_topic_corpus(tmp_path / "corpus.txt", n_sentences=100)
    out = tmp_path / "v.txt"
    model = run([f"-train_file={tmp_path / 'corpus.txt'}", "-min_count=1",
                 "-size=8", "-epoch=1", "-use_ps=true",
                 f"-output_file={out}", *flags], device="cpu")
    assert isinstance(model, PSWord2Vec) and model.trained_words > 0
    lines = out.read_text().splitlines()
    assert lines[0] == f"{model.dictionary.size} 8"
    assert len(lines) == model.dictionary.size + 1
