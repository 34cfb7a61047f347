"""Huffman length-list construction from cell occupancy (reference:
vq/huffbuild.c + vq/bookutil.c build_tree_from_lengths/
build_tree_from_lengths0).

The output is a Vorbis length list: zero means "unused entry"; the
non-zero lengths must satisfy Kraft equality so make_codewords accepts
them (sharedbook.c _make_words rejects over/under-specified trees).
"""

from __future__ import annotations

import heapq

import numpy as np


def occupancy_from_entries(entries: np.ndarray, n_entries: int,
                           guard: int = 1) -> np.ndarray:
    """Histogram of emitted entry numbers with a +guard floor on every
    cell (huffbuild.c adds `guard` so untrained cells stay codable)."""
    hist = np.bincount(np.asarray(entries, np.int64),
                       minlength=n_entries).astype(np.int64)
    return hist + guard


def huffbuild(hist: np.ndarray) -> np.ndarray:
    """Build the canonical Huffman code lengths for a histogram.

    hist[i] == 0 produces length 0 (unused entry, like
    build_tree_from_lengths0's sparse packing).  Single-used-entry
    books get length 1 (the Vorbis single-entry convention)."""
    hist = np.asarray(hist, np.int64)
    n = len(hist)
    lengths = np.zeros(n, np.int64)
    used = np.nonzero(hist > 0)[0]
    if len(used) == 0:
        return lengths
    if len(used) == 1:
        lengths[used[0]] = 1
        return lengths
    # standard heap Huffman over the dense list
    heap = [(int(hist[i]), idx) for idx, i in enumerate(used)]
    heapq.heapify(heap)
    parent = {}
    next_node = len(used)
    while len(heap) > 1:
        w1, a = heapq.heappop(heap)
        w2, b = heapq.heappop(heap)
        parent[a] = next_node
        parent[b] = next_node
        heapq.heappush(heap, (w1 + w2, next_node))
        next_node += 1
    root = heap[0][1]
    depth = {root: 0}
    # nodes were created in increasing id order; resolve top-down
    for node in range(next_node - 1, -1, -1):
        if node in parent:
            depth[node] = depth[parent[node]] + 1
    for idx, i in enumerate(used):
        lengths[i] = depth.get(idx, 0)
    # Vorbis codewords cap at 32 bits: flatten the histogram and
    # rebuild if the tree got too deep (rare, extremely skewed sets)
    if lengths.max() > 32:
        return huffbuild(np.where(hist > 0,
                                  np.sqrt(hist).astype(np.int64) + 1, 0))
    return lengths


def lengths_to_bits(lengths: np.ndarray, hist: np.ndarray) -> int:
    """Bits needed to code the training set with these lengths
    (bookutil.c's sanity report)."""
    return int((np.maximum(hist - 1, 0) * lengths).sum())
