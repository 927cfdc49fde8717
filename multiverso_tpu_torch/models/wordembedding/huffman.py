"""Huffman tree for hierarchical softmax.

TPU-native equivalent of the reference's ``HuffmanEncoder``
(ref: Applications/WordEmbedding/src/huffman_encoder.cpp): builds the
frequency-ordered binary tree and emits, per word, its code (left/right
bits) and point list (inner-node ids). Re-designed for batched TPU
consumption: codes/points are returned as dense ``[vocab, max_code_len]``
arrays padded with -1, ready for fixed-shape gather + mask inside one
jitted HS step instead of the reference's per-node scalar loop.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np


class HuffmanTree:
    def __init__(self, codes: np.ndarray, points: np.ndarray,
                 code_lengths: np.ndarray):
        self.codes = codes  # [vocab, L] 0/1, -1 pad
        self.points = points  # [vocab, L] inner node ids, -1 pad
        self.code_lengths = code_lengths  # [vocab]

    @property
    def max_code_length(self) -> int:
        return self.codes.shape[1]

    @property
    def num_inner_nodes(self) -> int:
        return int(self.points.max()) + 1 if self.points.size else 0


def build_huffman(counts: np.ndarray) -> HuffmanTree:
    """Standard Huffman construction over word frequencies."""
    vocab = len(counts)
    if vocab == 0:
        return HuffmanTree(np.zeros((0, 0), np.int32),
                           np.zeros((0, 0), np.int32),
                           np.zeros(0, np.int32))
    # Heap of (count, tiebreak, node). Leaves are 0..vocab-1; inner nodes
    # get ids vocab..2*vocab-2, renumbered to 0-based inner ids at the end.
    heap = [(int(c), i, i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    next_id = vocab
    parent = {}
    side = {}
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        parent[n1], side[n1] = next_id, 0
        parent[n2], side[n2] = next_id, 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = heap[0][2]

    codes_list, points_list = [], []
    for leaf in range(vocab):
        code, points = [], []
        node = leaf
        while node != root:
            code.append(side[node])
            points.append(parent[node] - vocab)  # 0-based inner node id
            node = parent[node]
        codes_list.append(code[::-1])
        points_list.append(points[::-1])

    max_len = max((len(c) for c in codes_list), default=0)
    codes = np.full((vocab, max_len), -1, np.int32)
    points = np.full((vocab, max_len), -1, np.int32)
    lengths = np.zeros(vocab, np.int32)
    for i, (code, point) in enumerate(zip(codes_list, points_list)):
        lengths[i] = len(code)
        codes[i, :len(code)] = code
        points[i, :len(point)] = point
    return HuffmanTree(codes, points, lengths)


def expected_code_length(tree: HuffmanTree,
                         counts: np.ndarray) -> float:
    freq = counts / max(counts.sum(), 1)
    return float((tree.code_lengths * freq).sum())
