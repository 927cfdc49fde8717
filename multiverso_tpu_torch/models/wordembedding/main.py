"""WordEmbedding CLI: word2vec through the parameter server on the card.

Port of ``multiverso_tpu/models/wordembedding/main.py``
(ref: Applications/WordEmbedding/src/main.cpp:16-28 and
distributed_wordembedding.cpp: epoch loop over blocks; rank 0 saves the
embeddings after the last epoch). Flags use the framework's -key=value
convention with the reference's names and defaults. This slice runs the
``-use_ps=true`` device pipeline; the other branches raise
``NotImplementedError`` naming their ROADMAP item.

Usage::

    python -m multiverso_tpu_torch.models.wordembedding.main \\
        -use_ps=true -train_file=corpus.txt -output_file=vectors.txt \\
        -size=128 -window=5 -negative=5 -neg_block=8 -epoch=1
"""

from __future__ import annotations

import gc
import sys
import time

from ... import init as mv_init, shutdown as mv_shutdown
from ...util import log
from ...util.configure import (define_bool, define_double, define_int,
                               define_string, get_flag, parse_cmd_flags)
from .data import TokenizedCorpus
from .device_train import PSDeviceCorpusTrainer
from .dictionary import Dictionary
from .model import PSWord2Vec, Word2VecConfig

define_string("train_file", "", "training corpus (';'-separated)")
define_string("output_file", "vectors.txt", "embedding output path")
define_string("vocab_file", "", "optional prebuilt vocab to load")
define_int("size", 100, "embedding dimension")
define_int("window", 5, "max context window")
define_int("negative", 5, "negative samples (0 with -hs)")
define_int("epoch", 1, "training epochs")
define_int("min_count", 5, "discard words rarer than this")
define_double("sample", 1e-3, "subsampling threshold")
define_double("init_learning_rate", 0.025, "initial learning rate")
define_bool("cbow", False, "CBOW instead of skip-gram")
define_bool("hs", False, "hierarchical softmax instead of negative "
                         "sampling")
define_bool("use_ps", False, "train through the parameter server")
define_int("batch_size", 4096, "pairs per step of the host-batch loop")
define_int("neg_block", 1, "device pipelines: share one draw of K "
           "negatives across this many consecutive centers")
define_bool("per_pair", False, "device pipelines, skip-gram: per-pair "
            "negatives + sequential window sub-steps")
define_bool("is_pipeline", True, "overlap loading with training")
define_bool("device_pipeline", True, "train through the device-resident "
            "pipeline; false = host-batch loop")
define_string("stopwords", "", "optional stopwords file (one word per "
              "line) filtered out of the vocabulary")


def run(argv=None) -> PSWord2Vec:
    parse_cmd_flags(list(argv) if argv is not None else sys.argv[1:])
    config = Word2VecConfig(
        embedding_size=get_flag("size"), window=get_flag("window"),
        negative=get_flag("negative"), epochs=get_flag("epoch"),
        min_count=get_flag("min_count"), sample=get_flag("sample"),
        init_learning_rate=get_flag("init_learning_rate"),
        cbow=get_flag("cbow"), hs=get_flag("hs"),
        batch_size=get_flag("batch_size"), use_ps=get_flag("use_ps"),
        neg_block=get_flag("neg_block"), per_pair=get_flag("per_pair"))
    train_file = get_flag("train_file")
    if not train_file:
        raise SystemExit("need -train_file=<corpus>")
    if not config.use_ps:
        raise NotImplementedError(
            "local word2vec (-use_ps=false) is not ported yet "
            "(ROADMAP A7, B5); pass -use_ps=true")
    if not get_flag("device_pipeline"):
        raise NotImplementedError(
            "the host-batch PS loop (-device_pipeline=false) is not "
            "ported yet (ROADMAP B9)")
    if get_flag("stopwords"):
        raise NotImplementedError(
            "-stopwords is not ported yet (ROADMAP A7)")

    if get_flag("vocab_file"):
        dictionary = Dictionary.load(get_flag("vocab_file"))
    else:
        dictionary = Dictionary.build(train_file,
                                      min_count=config.min_count)
    log.info("vocab: %d words, %d tokens", dictionary.size,
             dictionary.total_count)

    mv_init([])
    model = PSWord2Vec(config, dictionary)
    corpus = TokenizedCorpus.build(dictionary, train_file)
    trainer = PSDeviceCorpusTrainer(model, corpus)
    # The dictionary (one Python string per word) and the corpus live
    # for the whole run: keep the cyclic GC from re-walking them between
    # blocks (a full collection of a ~1M-word heap takes tens of ms).
    gc.collect()
    gc.freeze()
    start = time.perf_counter()
    for epoch in range(config.epochs):
        loss_sum, pair_count = trainer.train_epoch(seed=config.seed + epoch)
        elapsed = time.perf_counter() - start
        log.info("epoch %d: avg pair loss %.4f, %.0f words/s", epoch,
                 loss_sum / max(pair_count, 1),
                 model.trained_words / max(elapsed, 1e-9))
    if model._in_table.zoo.rank == 0 and get_flag("output_file"):
        model.save_embeddings(get_flag("output_file"))
    mv_shutdown()
    return model


if __name__ == "__main__":
    run()
