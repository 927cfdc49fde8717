"""The port's model-average word2vec against the JAX package's.

- ``_ma_group_fn`` (B16 on the word2vec path: G local SGNS steps a
  replica slot on its corpus shard, then K19's mean of the replicas)
  against the reference's at the reference test's sizes
  (tests/test_wordembedding.py TestMAWord2Vec: C 64, W 2, K 3, 512
  kept tokens a slot, V 40, D 8, G 2, 8 slots), each slot replaying its
  device's ``jax.random`` key: both tables, loss and pairs at rtol 1e-5
  / atol 1e-7 (the ids are the reference's bit for bit; float sums of
  the scatter-adds and of the losses run in another order). Chained
  groups with the advanced draws give a different loss, and agree with
  the reference's second group too; a second case has uneven per-slot
  kept counts and a padded step (base ``n_kept``, lr 0).
- ``MACorpusTrainer`` sync against overlap (dense and sharded):
  bit-identical tables on both ranks and a falling loss (the reference
  test's contract).
- ``MACorpusTrainer`` against the reference's over ``LocalCluster(2,
  argv=["-ma=true"])`` at the reference test's settings, from the
  reference's initial tables (``convert.load_reference_embeddings``)
  with its ``jax.random`` draws replayed: tables, losses and rounds at
  rtol 1e-5 / atol 1e-7 — the same corpus on both ranks, and uneven
  shards (a corpus a rank) with ``group_quota``.
- Uneven shards with ``group_quota`` give equal ``comm_rounds`` and
  replicas that agree.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models.wordembedding import (
    Dictionary as JDictionary, MACorpusTrainer as JMACorpusTrainer,
    TokenizedCorpus as JTokenizedCorpus, Word2Vec as JWord2Vec,
    Word2VecConfig as JConfig)
from multiverso_tpu.models.wordembedding.device_train import (
    _ma_group_fn as j_ma_group_fn)
from multiverso_tpu.runtime.cluster import LocalCluster as JCluster
from multiverso_tpu.sharding import mesh as jmeshlib
from multiverso_tpu_torch import kernels
from multiverso_tpu_torch.models.wordembedding import (
    Dictionary, MACorpusTrainer, TokenizedCorpus, TorchDraws, Word2Vec,
    Word2VecConfig)
from multiverso_tpu_torch.models.wordembedding.convert import (
    load_reference_embeddings)
from multiverso_tpu_torch.models.wordembedding.device_train import (
    _ma_group_fn)
from multiverso_tpu_torch.runtime.cluster import LocalCluster as TCluster
from multiverso_tpu_torch.sharding import mesh as meshlib

RTOL, ATOL = 1e-5, 1e-7
MA = ["-ma=true"]


@pytest.fixture(autouse=True)
def _port_teardown_guard():
    """Every test returns the PORT's role-thread count to its baseline
    and leaves the port's flag registry at its defaults."""
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


class JaxKeyDraws:
    """One slot's draws, replaying the reference's per-device key in
    ``_ma_group_fn``: per step ``key, sub = split(key)``, ``sub`` split
    three ways into the shrink, negative index and keep keys
    (``_apply_step``, ``_band_former``, ``_draw_negs``)."""

    def __init__(self, key):
        self.key = key

    def step_draws(self, seed, step, C, W, neg_shape, V):
        self.key, sub = jax.random.split(self.key)
        k_shrink, k_idx, k_keep = jax.random.split(sub, 3)
        return (_t(jax.random.randint(k_shrink, (C,), 1, W + 1)),
                _t(jax.random.randint(k_idx, neg_shape, 0, V)),
                _t(jax.random.uniform(k_keep, neg_shape)))


class JaxStepDraws:
    """The local trainer's draws replaying the reference's stream
    (as tests/test_torch_local.py's): ``PRNGKey(seed)`` split into
    (key, prep_key), the subsampling uniforms from prep_key, then per
    step ``key, sub = split(key)`` and ``sub`` split three ways."""

    def epoch_uniforms(self, seed, n_tokens):
        key, prep_key = jax.random.split(jax.random.PRNGKey(seed))
        self._keys = JaxKeyDraws(key)
        return _t(jax.random.uniform(prep_key, (n_tokens,)))

    def step_draws(self, seed, step, C, W, neg_shape, V):
        return self._keys.step_draws(seed, step, C, W, neg_shape, V)


C, W, K, N_LOCAL, V, D, G = 64, 2, 3, 512, 40, 8, 2
N_DEV = 8


def _group_inputs(uneven):
    rng = np.random.default_rng(0)
    emb_in = ((rng.random((V, D)).astype(np.float32) - 0.5) / D)
    emb_out = np.zeros((V, D), np.float32)
    kept = rng.integers(0, V, N_DEV * N_LOCAL).astype(np.int32)
    ksent = np.repeat(np.arange(N_DEV * N_LOCAL // 16, dtype=np.int32), 16)
    bases = (np.arange(G) * C).astype(np.int32)
    lrs = np.full(G, 0.05, np.float32)
    n_kept_local = np.full(N_DEV, N_LOCAL, np.int32)
    neg_prob = np.ones(V, np.float32)
    neg_alias = np.arange(V, dtype=np.int32)
    if uneven:
        # Slots with fewer kept tokens (their tails masked), a Zipf-like
        # negative table, and a padded last step (base n_kept, lr 0).
        n_kept_local = np.array([512, 300, 77, 64, 500, 129, 512, 1],
                                np.int32)
        neg_prob = rng.random(V).astype(np.float32)
        neg_alias = rng.integers(0, V, V).astype(np.int32)
        bases = np.array([0, C, N_LOCAL], np.int32)
        lrs = np.array([0.05, 0.04, 0.0], np.float32)
    return (emb_in, emb_out, kept, ksent, neg_prob, neg_alias, bases, lrs,
            n_kept_local)


@pytest.mark.parametrize("uneven", [False, True])
def test_ma_group_matches_reference(uneven):
    (emb_in, emb_out, kept, ksent, neg_prob, neg_alias, bases, lrs,
     n_kept_local) = _group_inputs(uneven)
    jfn = j_ma_group_fn(jmeshlib.local_mesh(N_DEV), C, W, K)
    keys = jax.random.split(jax.random.PRNGKey(0), N_DEV)
    fn = _ma_group_fn(meshlib.local_mesh(N_DEV, device="cpu"), C, W, K)
    draws = [JaxKeyDraws(keys[s]) for s in range(N_DEV)]
    j_in, j_out = jnp.asarray(emb_in), jnp.asarray(emb_out)
    t_in, t_out = _t(emb_in), _t(emb_out)
    kernels.reset_launch_counts()
    losses = []
    for _ in range(2):   # a chained second group draws fresh windows
        j_in, j_out, j_loss, j_pairs, keys = jfn(
            j_in, j_out, jnp.asarray(kept), jnp.asarray(ksent),
            jnp.asarray(neg_prob), jnp.asarray(neg_alias), keys,
            jnp.asarray(bases), jnp.asarray(lrs), jnp.asarray(n_kept_local))
        t_in, t_out, loss, pairs = fn(
            t_in, t_out, _t(kept), _t(ksent), _t(neg_prob), _t(neg_alias),
            draws, bases, lrs, n_kept_local)
        assert tuple(t_in.shape) == (V, D) and tuple(t_out.shape) == (V, D)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)
        assert float(pairs) == float(j_pairs) > 0
        np.testing.assert_allclose(t_in.numpy(), np.asarray(j_in),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   rtol=RTOL, atol=ATOL)
        losses.append(float(loss))
        for s in range(N_DEV):   # the providers advanced as the keys
            np.testing.assert_array_equal(np.asarray(draws[s].key),
                                          np.asarray(keys[s]))
    assert losses[1] != losses[0]
    assert np.abs(t_out.numpy()).max() > 0   # it trained
    # CPU tensors: K19's wrapper ran its plain version, no launch.
    assert kernels.launch_counts()["mesh_allreduce"] == 0


def test_ma_group_averages_the_replicas():
    # Each slot's replica, trained alone, then averaged by hand in slot
    # order, is the group's result bit for bit.
    (emb_in, emb_out, kept, ksent, neg_prob, neg_alias, bases, lrs,
     n_kept_local) = _group_inputs(True)
    n = 4
    kept, ksent = kept[:n * N_LOCAL], ksent[:n * N_LOCAL]
    mesh = meshlib.local_mesh(n, device="cpu")
    gens = [TorchDraws("cpu") for _ in range(n)]
    for s, d in enumerate(gens):
        d.generator.manual_seed(s)
    avg_in, avg_out, loss, pairs = _ma_group_fn(mesh, C, W, K)(
        _t(emb_in), _t(emb_out), _t(kept), _t(ksent), _t(neg_prob),
        _t(neg_alias), gens, bases, lrs, n_kept_local[:n])
    one = meshlib.local_mesh(1, device="cpu")
    reps, total = [], None
    for s in range(n):
        d = TorchDraws("cpu")
        d.generator.manual_seed(s)
        rep_in, rep_out, l_s, _ = _ma_group_fn(one, C, W, K)(
            _t(emb_in), _t(emb_out), _t(kept[s * N_LOCAL:(s + 1) * N_LOCAL]),
            _t(ksent[s * N_LOCAL:(s + 1) * N_LOCAL]), _t(neg_prob),
            _t(neg_alias), [d], bases, lrs, n_kept_local[s:s + 1])
        reps.append((rep_in, rep_out))
        total = l_s if total is None else total + l_s
    for i, got in enumerate((avg_in, avg_out)):
        acc = reps[0][i].clone()
        for s in range(1, n):
            acc = acc + reps[s][i]
        torch.testing.assert_close(got, acc / torch.tensor(float(n)),
                                   rtol=0, atol=0)
    assert float(loss) == float(total)


def _ma_run(api, tok_for, d, config, init, draws, overlap, sharded,
            epochs=2, quota=0):
    """One MACorpusTrainer per rank of a 2-rank -ma cluster (the
    reference test's settings); per rank (input table, losses, rounds)."""
    def body(rank):
        if api == "jax":
            model = JWord2Vec(config(JConfig), d)
            trainer = JMACorpusTrainer(model, tok_for(rank), avg_every=2,
                                       overlap=overlap, sharded=sharded,
                                       centers_per_step=64,
                                       steps_per_dispatch=1)
        else:
            model = Word2Vec(config(Word2VecConfig), d, device="cpu")
            if init is not None:
                load_reference_embeddings(model, *init)
            kw = dict(draws=JaxStepDraws()) if draws else {}
            trainer = MACorpusTrainer(model, tok_for(rank), avg_every=2,
                                      overlap=overlap, sharded=sharded,
                                      centers_per_step=64,
                                      steps_per_dispatch=1, **kw)
        losses = []
        for epoch in range(epochs):
            loss, examples = trainer.train_epoch(seed=epoch,
                                                 group_quota=quota)
            losses.append(loss / max(examples, 1))
        trainer.finish()
        emb = model._emb_in
        emb = np.asarray(emb) if api == "jax" else emb.numpy()
        return emb.copy(), losses, trainer.comm_rounds

    if api == "jax":
        return JCluster(2, argv=MA).run(body)
    return TCluster(2, argv=MA, device="cpu").run(body)


def _config(cls, seed=7, epochs=2):
    return cls(embedding_size=8, window=2, epochs=epochs,
               init_learning_rate=0.02, batch_size=256, sample=0,
               negative=3, seed=seed)


def _corpus(tmp_path, n_sentences=200):
    path = tmp_path / "corpus.txt"
    write_topic_corpus(path, n_sentences=n_sentences)
    return path


@pytest.mark.parametrize("sharded", [False, True])
def test_overlap_bit_identical_to_sync_and_trains(tmp_path, sharded):
    path = _corpus(tmp_path)
    d = Dictionary.build(str(path), min_count=1)
    tok = TokenizedCorpus.build(d, str(path))
    runs = [_ma_run("torch", lambda r: tok, d, _config, None, False,
                    overlap, sharded) for overlap in (False, True)]
    sync, over = runs
    for rank in range(2):
        np.testing.assert_array_equal(sync[rank][0], over[rank][0])
    np.testing.assert_array_equal(sync[0][0], sync[1][0])
    losses = sync[0][1]
    assert losses[-1] < losses[0], losses
    assert sync[0][2] > 0 and sync[0][2] == over[0][2]


@pytest.mark.parametrize("setting", ["same_corpus", "uneven_quota"])
def test_trainer_matches_reference(tmp_path, setting):
    if setting == "same_corpus":
        # tests/test_wordembedding.py TestMACorpusTrainer._run, dense,
        # overlapped.
        path = _corpus(tmp_path)
        jd = JDictionary.build(str(path), min_count=1)
        d = Dictionary.build(str(path), min_count=1)
        jtoks = [JTokenizedCorpus.build(jd, str(path))] * 2
        toks = [TokenizedCorpus.build(d, str(path))] * 2
        seed, epochs, quota = 7, 2, 0
    else:
        # ... test_uneven_shards_with_group_quota: a corpus a rank.
        paths = [tmp_path / "a.txt", tmp_path / "b.txt"]
        write_topic_corpus(paths[0], n_sentences=150)
        write_topic_corpus(paths[1], n_sentences=60, seed=1)
        jd = JDictionary.build(str(paths[0]), min_count=1)
        d = Dictionary.build(str(paths[0]), min_count=1)
        jtoks = [JTokenizedCorpus.build(jd, str(p)) for p in paths]
        toks = [TokenizedCorpus.build(d, str(p)) for p in paths]
        seed, epochs, quota = 5, 1, 40
    assert d.words == jd.words
    config = lambda cls: _config(cls, seed, epochs)   # noqa: E731
    jmodel = JWord2Vec(config(JConfig), jd)
    init = (np.array(jmodel._emb_in), np.array(jmodel._emb_out))
    want = _ma_run("jax", lambda r: jtoks[r], jd, config, None, True, True,
                   False, epochs, quota)
    got = _ma_run("torch", lambda r: toks[r], d, config, init, True, True,
                  False, epochs, quota)
    for rank in range(2):
        np.testing.assert_allclose(got[rank][0], want[rank][0], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got[rank][1], want[rank][1], rtol=RTOL)
        assert got[rank][2] == want[rank][2] > 0


def test_uneven_shards_with_group_quota(tmp_path):
    paths = [tmp_path / "a.txt", tmp_path / "b.txt"]
    write_topic_corpus(paths[0], n_sentences=150)
    write_topic_corpus(paths[1], n_sentences=60, seed=1)
    d = Dictionary.build(str(paths[0]), min_count=1)
    toks = [TokenizedCorpus.build(d, str(p)) for p in paths]
    out = _ma_run("torch", lambda r: toks[r], d,
                  lambda cls: _config(cls, 5, 1), None, False, True, False,
                  epochs=1, quota=40)
    assert out[0][2] == out[1][2] == 20   # same collective count
    assert abs(float(out[0][0].sum()) - float(out[1][0].sum())) < 1e-5
