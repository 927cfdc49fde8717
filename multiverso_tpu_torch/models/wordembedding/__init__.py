"""WordEmbedding application (ref: Applications/WordEmbedding)."""

from .data import (BlockLoader, CbowBatch, PairBatch,  # noqa: F401
                   TokenizedCorpus, iter_pair_batches, iter_sentences,
                   sentence_pairs)
from .device_train import (DeviceCorpusTrainer,  # noqa: F401
                           PSDeviceCorpusTrainer, TorchDraws)
from .dictionary import Dictionary  # noqa: F401
from .huffman import HuffmanTree, build_huffman  # noqa: F401
from .model import (PSWord2Vec, Word2Vec, Word2VecConfig,  # noqa: F401
                    build_alias)
