"""Vocabulary/word-frequency preprocessor CLI.

Port of ``multiverso_tpu/models/wordembedding/preprocess.py``. The
reference ships a standalone word_count generator
(ref: Applications/WordEmbedding/preprocess/word_count.cpp:30-46:
``word_count [-train_file f] [-save_vocab_file v] [-min_count n]``, with
an optional stopword list, preprocess/Readme.txt). Same job here: count
the corpus once, filter by min_count and stopwords, save the vocab for
``main.py -vocab_file=`` so multi-worker runs skip per-rank dictionary
builds.

    python -m multiverso_tpu_torch.models.wordembedding.preprocess \\
        -train_file=corpus.txt -save_vocab_file=vocab.txt \\
        [-min_count=5] [-sw_file=stopwords.txt]
"""

from __future__ import annotations

import sys

from ...util import log
from ...util.configure import (define_int, define_string, get_flag,
                               parse_cmd_flags)
from .dictionary import Dictionary

# Shared with main.py (the registry keeps the first definition).
define_string("train_file", "", "training corpus (';'-separated)")
define_int("min_count", 5, "discard words rarer than this")
define_string("save_vocab_file", "", "vocab output path")
define_string("sw_file", "", "optional stopword list (one word per line)")


def run(argv=None) -> Dictionary:
    parse_cmd_flags(list(argv) if argv is not None else sys.argv[1:])
    train_file = get_flag("train_file")
    out = get_flag("save_vocab_file")
    if not train_file or not out:
        raise SystemExit("usage: preprocess -train_file=<corpus> "
                         "-save_vocab_file=<path> [-min_count=5] "
                         "[-sw_file=<stopwords>]")
    stopwords = None
    if get_flag("sw_file"):
        with open(get_flag("sw_file")) as f:
            stopwords = {line.strip() for line in f if line.strip()}
    dictionary = Dictionary.build(train_file,
                                  min_count=get_flag("min_count"),
                                  stopwords=stopwords)
    dictionary.store(out)
    log.info("vocab: %d words (min_count=%d) -> %s", dictionary.size,
             get_flag("min_count"), out)
    return dictionary


if __name__ == "__main__":
    run()
