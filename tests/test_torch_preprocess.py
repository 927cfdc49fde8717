"""The vocabulary preprocessor: the port's
``models/wordembedding/preprocess.py`` against the JAX package's.

Both ``run`` entry points count the same corpus, filter by
``-min_count`` and a ``-sw_file`` stopword list, and write the same
vocab bytes to ``-save_vocab_file``; the port's vocab loads back into
its ``Dictionary`` with the same words and counts.
"""

import numpy as np
import pytest

from multiverso_tpu.models.wordembedding import preprocess as jpre
from multiverso_tpu.util import configure as jconfigure
from multiverso_tpu_torch.models.wordembedding import Dictionary
from multiverso_tpu_torch.models.wordembedding import preprocess as tpre
from multiverso_tpu_torch.util import configure as tconfigure


@pytest.fixture(autouse=True)
def _reset_port_flags():
    yield
    tconfigure.reset_flags()
    jconfigure.reset_flags()


def write_corpus(path, seed=0):
    """Zipf-skewed words over 300 lines, ties in count included."""
    rng = np.random.default_rng(seed)
    words = ["the", "a", "of"] + [f"w{i}" for i in range(60)]
    lines = []
    for _ in range(300):
        ids = np.minimum(rng.zipf(1.3, size=rng.integers(3, 15)) - 1,
                         len(words) - 1)
        lines.append(" ".join(words[i] for i in ids))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("min_count", [1, 3, 5])
@pytest.mark.parametrize("stopwords", [False, True])
def test_vocab_bytes_match_reference(tmp_path, min_count, stopwords):
    corpus = tmp_path / "corpus.txt"
    write_corpus(corpus)
    extra = []
    if stopwords:
        sw = tmp_path / "stop.txt"
        sw.write_text("the\na\n\nof\n")
        extra = [f"-sw_file={sw}"]
    outs = {}
    for name, mod in (("reference", jpre), ("port", tpre)):
        out = tmp_path / f"vocab_{name}.txt"
        mod.run([f"-train_file={corpus}", f"-save_vocab_file={out}",
                 f"-min_count={min_count}"] + extra)
        outs[name] = out.read_bytes()
    assert outs["port"] == outs["reference"]
    assert outs["port"]
    loaded = Dictionary.load(str(tmp_path / "vocab_port.txt"))
    assert loaded.counts.min() >= min_count
    assert ("the" in loaded.word2id) != stopwords


def test_run_returns_the_dictionary(tmp_path):
    corpus = tmp_path / "corpus.txt"
    write_corpus(corpus, seed=1)
    out = tmp_path / "vocab.txt"
    got = tpre.run([f"-train_file={corpus}", f"-save_vocab_file={out}",
                    "-min_count=2"])
    want = Dictionary.build(str(corpus), min_count=2)
    assert got.words == want.words
    np.testing.assert_array_equal(got.counts, want.counts)


def test_usage_without_paths():
    with pytest.raises(SystemExit, match="usage"):
        tpre.run(["-min_count=2"])
