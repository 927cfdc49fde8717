"""K11's summation order and K1's tiles on the CPU, against the reference.

- K11 ``sparse_lr_forward``: ``sparse_lr_forward_ordered`` is the CPU
  model of the kernel's order (G = ``forward_lanes(K, C)`` lanes a sample,
  each summing its positions in order, then the lanes' xor tree), which
  the card holds bit for bit. Here it is held to the plain version within
  the kernel's present tolerance (|err| <= 1e-5 + 1e-4 |plain|) with the
  same hits, and to the reference's ``make_sparse_step``: loss within
  rtol 1e-5 (the logits sum in another order), the same correct count.
- ``forward_lanes`` at every ``lr_*`` path's shape.
- K1 ``subsample_compact``: ``subsample_compact_tiled``, the CPU model of
  the kernel's tiles, look-back and two passes, bit for bit against the
  reference's ``_prep`` with its ``jax.random.uniform`` draw.
- K21 ``dense_lr_forward``: its plain version is K11's finish after the
  logits (the reference's dense stages: ``test_torch_logreg_dense.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models.logreg import Configure as JConfigure
from multiverso_tpu.models.logreg import objective as jobjective
from multiverso_tpu.models.wordembedding import device_train as jdt
from multiverso_tpu_torch.kernels import logreg as lrk
from multiverso_tpu_torch.kernels import subsample as ks

# -- K11 --

R_IN = 200          # input_size: rows 0..199, the padding row 200


def lr_batch(seed: int, B: int, K: int, classes: int, width: int = 0):
    """``B`` samples of ``K`` keys (``width`` real ones, the rest the
    padding key with value 0), with keys past -R and at -1, repeats,
    explicit zero values, zero-weight samples and out-of-range labels."""
    rng = np.random.default_rng(seed)
    R = R_IN + 1
    width = width or K
    keys = rng.integers(0, R_IN, (B, K))
    keys[:, width:] = R_IN
    keys[0, :3] = [-1, -R - 5, R + 3]
    keys[1, 1] = keys[1, 0]
    values = (rng.standard_normal((B, K)) * 0.7).astype(np.float32)
    values[:, width:] = 0.0
    values[2, 0] = 0.0
    labels = rng.integers(0, max(classes, 2), B).astype(np.int32)
    labels[3] = -1
    weights = rng.choice(np.float32([0.0, 0.5, 1.0, 1.0]), B)
    return keys.astype(np.int32), values, labels, weights


def lr_table(seed: int, classes: int, ftrl: bool):
    rng = np.random.default_rng(seed + 100)
    shape = (R_IN + 1, classes)
    if not ftrl:
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return ((rng.standard_normal(shape) * 2).astype(np.float32),
            (rng.random(shape) * 4).astype(np.float32))


CASES = [
    # (objective, classes, B, K, width, ftrl)
    ("sigmoid", 1, 37, 64, 39, False),     # criteo's padded 64, B ragged
    ("sigmoid", 1, 40, 39, 39, False),     # K = 39: not a multiple of 8
    ("sigmoid", 1, 9, 5, 5, False),        # fewer keys than lanes
    ("sigmoid", 1, 33, 150, 150, False),   # several chunks a lane
    ("default", 1, 21, 64, 39, False),
    ("softmax", 4, 19, 16, 12, False),     # the warp form
    ("default", 3, 11, 40, 40, False),
    ("sigmoid", 1, 29, 64, 39, True),      # FTRL's z and n
]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ordered_forward_against_plain_and_reference(case):
    objective_type, C, B, K, width, ftrl_on = case
    keys, values, labels, weights = lr_batch(sum(map(ord, str(case))), B, K,
                                             C, width)
    table_np = lr_table(B, C, ftrl_on)
    ftrl = lrk.Ftrl(0.1, 1.0, 0.3, 0.01) if ftrl_on else None
    table = tuple(_torch(*table_np)) if ftrl_on else _torch(table_np)[0]
    act = {"sigmoid": lrk.ACT_SIGMOID, "softmax": lrk.ACT_SOFTMAX}.get(
        objective_type, lrk.ACT_LINEAR)
    args = _torch(keys, values, labels, weights)
    got = lrk.sparse_lr_forward_ordered(table, *args, act, ftrl)
    plain = lrk.sparse_lr_forward_plain(table, *args, act, ftrl)
    for name, g, p in zip(("pred", "diff"), got[:2], plain[:2]):
        assert bool(((g - p).abs() <= 1e-5 + 1e-4 * p.abs()).all()), name
    np.testing.assert_allclose(float(got[2].sum()), float(plain[2].sum()),
                               rtol=1e-5)
    assert torch.equal(got[3], plain[3])
    # The reference's loss and correct count (FTRL: its weights_of).
    w = np.asarray(lrk.ftrl_weights(*table, ftrl)) if ftrl_on else table_np
    kw = dict(input_size=R_IN, output_size=C, sparse=True,
              objective_type=objective_type)
    loss, correct, _ = jobjective.make_sparse_step(JConfigure(**kw))(
        *map(jnp.asarray, (w, keys, values, labels, weights)))
    np.testing.assert_allclose(float(got[2].sum()), float(loss), rtol=1e-5)
    assert int(got[3].sum()) == int(correct)
    # Without labels: pred alone, the same bits.
    pred = lrk.sparse_lr_forward_ordered(table, args[0], args[1], None,
                                         None, act, ftrl)
    assert torch.equal(pred.view(torch.int32), got[0].view(torch.int32))


def test_ordered_forward_sums_in_the_kernels_order():
    """One sample whose sum depends on its order: 1 + 2^-24 + ... lands
    where the kernel's lanes put it, not where a left-to-right sum
    does."""
    K = 16
    keys = torch.arange(K, dtype=torch.int32)[None]
    w = torch.zeros(K + 1, 1)
    w[:K, 0] = torch.tensor([1.0] + [2.0 ** -24] * (K - 1))
    values = torch.ones(1, K)
    got = lrk.sparse_lr_forward_ordered(w, keys, values, None, None,
                                        lrk.ACT_LINEAR)
    # Lanes of 2 (K = 16): lane 0 holds 1 and 7 halves of an ulp (1 + 7 *
    # 2^-24 rounds to 1 at each step), lane 1 eight of them (2^-21): the
    # tree adds the two, 1 + 2^-21.
    assert lrk.forward_lanes(K, 1) == 2
    assert float(got[0, 0]) == 1.0 + 2.0 ** -21
    assert float(sum([1.0] + [2.0 ** -24] * (K - 1))) != float(got[0, 0])


@pytest.mark.parametrize("K,C,lanes", [
    (64, 1, 8),    # every lr_* path: criteo's 39 keys padded to 64
    (39, 1, 8),    # 39 keys unpadded: 5 terms a lane
    (8, 1, 1), (9, 1, 2), (16, 1, 2), (17, 1, 4), (100, 1, 16),
    (1000, 1, 32), (64, 10, 32), (4, 4, 32)])
def test_forward_lanes(K, C, lanes):
    assert lrk.forward_lanes(K, C) == lanes


# -- K1 --

def _prep_case(T: int, V: int, keep_lo: float, keep_hi: float, seed: int):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, V, T).astype(np.int32)
    sent = np.sort(rng.integers(0, max(T // 20, 1), T)).astype(np.int32)
    keep = rng.uniform(keep_lo, keep_hi, V).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = [np.asarray(x) for x in jdt._prep(
        jnp.asarray(flat), jnp.asarray(sent), jnp.asarray(keep), key)]
    u = np.array(jax.random.uniform(key, flat.shape))
    return (flat, sent, keep, u), want


@pytest.mark.parametrize("T,keep_lo,keep_hi", [
    (1000, 0.05, 1.0),                 # below one tile
    (ks.TILE, 0.2, 0.9),               # exactly one tile
    (3 * ks.TILE + 777, 0.05, 1.0),    # not a multiple of the tile
    (40 * ks.TILE + 5, 0.3, 0.6),      # more tiles than a look-back window
    (2 * ks.TILE + 9, 1.5, 2.0),       # all kept
    (2 * ks.TILE + 9, 0.0, 0.0),       # none kept
])
@pytest.mark.parametrize("seed", [0, 1])
def test_tiled_model_matches_prep(T, keep_lo, keep_hi, seed):
    inputs, want = _prep_case(T, 300, keep_lo, keep_hi, seed + T)
    got = ks.subsample_compact_tiled(*map(torch.from_numpy, inputs),
                                     seed=seed)
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g.numpy(), w)
    # The tiles' exclusive prefixes are the kept counts before them.
    flat, sent, keep, u = inputs
    mask = u < keep[flat]
    assert len(got[3]) == ks.tiles_of(T)
    for tile, before in enumerate(got[3]):
        assert before == int(mask[:tile * ks.TILE].sum())
    if keep_lo > 1:
        assert int(got[2]) == T
    if keep_hi == 0:
        assert int(got[2]) == 0 and (got[1].numpy() == -1).all()


def test_look_back_windows():
    """Any mix of published counts and prefixes gives the exact prefix,
    within one window and across several."""
    rng = np.random.default_rng(3)
    counts = rng.integers(0, ks.TILE + 1, 150)
    inclusive = np.cumsum(counts)
    for trial in range(20):
        status = [(ks.PREFIX, int(inclusive[0]))]
        for t in range(1, len(counts)):
            p = 0.0 if trial % 4 == 0 else rng.random()
            status.append((ks.PREFIX, int(inclusive[t])) if p > 0.7
                          else (ks.AGGREGATE, int(counts[t])))
        for tile in (1, 2, 31, 32, 33, 64, 65, 149):
            assert ks.look_back(status, tile) == int(inclusive[tile - 1])


def test_tile_count_at_the_bench_corpus():
    """The bench corpus's 6M tokens: 1,465 tiles of 4,096 (status words
    and second-launch blocks alike); none for an empty corpus."""
    assert ks.tiles_of(6_000_000) == 1465
    assert ks.tiles_of(4096) == 1 and ks.tiles_of(4097) == 2
    assert ks.tiles_of(0) == 0


# -- K21 --

@pytest.mark.parametrize("objective_type,classes", [("sigmoid", 1),
                                                    ("softmax", 4),
                                                    ("default", 3)])
def test_dense_forward_is_k11s_finish(objective_type, classes):
    """K21's plain version is K11's after its logits: fed the logits K11's
    ordered model sums, the same bits, labelled or not."""
    keys, values, labels, weights = lr_batch(5, 24, 16, classes)
    table = torch.from_numpy(lr_table(24, classes, False))
    act = {"sigmoid": lrk.ACT_SIGMOID, "softmax": lrk.ACT_SOFTMAX}.get(
        objective_type, lrk.ACT_LINEAR)
    args = _torch(keys, values, labels, weights)
    sparse = lrk.sparse_lr_forward_plain(table, *args, act)
    ids = lrk.gather_ids(args[0], table.shape[0])
    logits = lrk.dot(lrk.f(args[1])[..., None], lrk.f(table[ids]), 1)
    dense = lrk.dense_lr_forward(logits, args[2], args[3], act)
    for s, d in zip(sparse, dense):
        assert torch.equal(s.reshape(-1).view(torch.int32),
                           d.reshape(-1).view(torch.int32))
    pred = lrk.dense_lr_forward(logits, act=act)
    assert torch.equal(pred.view(torch.int32), dense[0].view(torch.int32))


def test_new_wrappers_raise_on_other_devices():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        lrk.dense_lr_forward(torch.zeros(2, 3, device=meta))
    ints = torch.zeros(8, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        ks.subsample_compact(ints, ints, torch.zeros(4, device=meta),
                             torch.zeros(8, device=meta))
