"""FP-Growth frequent-pattern mining over VAQ codebooks.

Re-implements the reference's FP-tree miner
(``utils/FPGrowth/fptree.hpp:20-42``, ``fptree.cpp:14-344``) and its
codebook front-end ``findFrequentPattern`` (``utils/Experiment.hpp:15-18``):
each encoded vector's code row is a transaction whose items are the centroid
ids made globally unique by adding a per-subspace offset
(``fptree.cpp:95-125``), and FP-Growth returns every itemset whose support
(number of rows containing all its items) reaches ``min_support``.

This subsystem is host-side by design: it is a train-time/offline analysis
tool (the reference only invokes it inside a ``#if 0`` block,
``demo_vaq.cpp:130-261``), not a query-path kernel — there is nothing for
the device here, so it stays NumPy/pure-Python.

Note one deliberate divergence: the reference computes the per-subspace item
offsets as ``offsets[i] = centroidsNum[i] + offsets[i-1]``
(``fptree.cpp:100-103``), which collides item ids across subspaces whenever
``centroidsNum`` is non-uniform (offset of subspace 1 is subspace 1's own
count, not subspace 0's). We use the standard exclusive cumulative sum, which
matches the reference exactly on uniform allocations (the only configuration
its dormant demo uses) and is collision-free on variance-aware ones.
"""
from __future__ import annotations

import itertools
from collections import defaultdict
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

Pattern = Tuple[FrozenSet[int], int]


class _Node:
    __slots__ = ("item", "count", "parent", "children")

    def __init__(self, item: int, parent: "_Node | None"):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children: Dict[int, _Node] = {}


def _build_tree(transactions: Sequence[Sequence[int]], min_support: int):
    """FP-tree construction (``fptree.cpp:14-93``): count item frequencies,
    drop infrequent items, insert each transaction's surviving items in
    descending-frequency order (ties by item id, matching the reference's
    ``frequency_comparator`` tie-break on the map key)."""
    freq: Dict[int, int] = defaultdict(int)
    for t in transactions:
        for it in set(t):
            freq[it] += 1
    freq = {it: c for it, c in freq.items() if c >= min_support}
    if not freq:
        return None, {}, {}
    # descending frequency, ascending item id on ties — a deterministic
    # total order so identical inputs give identical trees
    order = {it: r for r, it in enumerate(
        sorted(freq, key=lambda it: (-freq[it], it)))}
    root = _Node(-1, None)
    header: Dict[int, List[_Node]] = defaultdict(list)
    for t in transactions:
        items = sorted({it for it in t if it in freq},
                       key=order.__getitem__)
        node = root
        for it in items:
            child = node.children.get(it)
            if child is None:
                child = _Node(it, node)
                node.children[it] = child
                header[it].append(child)
            child.count += 1
            node = child
    return root, header, freq


def _single_path(root: _Node):
    """If the tree is one chain, return it (item, count) list, else None
    (the reference's single-path shortcut, ``fptree.cpp:222-249``)."""
    path = []
    node = root
    while node.children:
        if len(node.children) > 1:
            return None
        (node,) = node.children.values()
        path.append((node.item, node.count))
    return path


def _growth(transactions: Sequence[Sequence[int]], min_support: int,
            ) -> Dict[FrozenSet[int], int]:
    root, header, freq = _build_tree(transactions, min_support)
    if root is None:
        return {}
    path = _single_path(root)
    if path is not None:
        # all subsets of the single path; support of a subset = min count
        # along it (counts are non-increasing down the chain)
        out: Dict[FrozenSet[int], int] = {}
        for r in range(1, len(path) + 1):
            for combo in itertools.combinations(path, r):
                out[frozenset(it for it, _ in combo)] = min(
                    c for _, c in combo)
        return out

    out = {}
    # least-frequent first, as the classic algorithm (and the reference's
    # reverse header-table iteration, fptree.cpp:252-344)
    for item in sorted(freq, key=lambda it: (freq[it], -it)):
        support = sum(n.count for n in header[item])
        out[frozenset([item])] = support
        # conditional pattern base: prefix paths above each occurrence,
        # replicated by that occurrence's count
        cond: List[List[int]] = []
        for node in header[item]:
            prefix = []
            p = node.parent
            while p is not None and p.item != -1:
                prefix.append(p.item)
                p = p.parent
            if prefix:
                cond.extend([prefix] * node.count)
        for pat, cnt in _growth(cond, min_support).items():
            out[pat | {item}] = cnt
    return out


def fptree_growth(transactions: Sequence[Sequence[int]], min_support: int,
                  ) -> Dict[FrozenSet[int], int]:
    """All itemsets with support ≥ ``min_support`` → {itemset: support}
    (``fptree_growth``, ``fptree.cpp:213-344``)."""
    if min_support < 1:
        raise ValueError("min_support must be >= 1")
    return _growth(transactions, min_support)


def subspace_offsets(centroids_num: Sequence[int]) -> np.ndarray:
    """Exclusive cumsum making (subspace, code) pairs globally unique items
    (intent of ``fptree.cpp:100-103``; see module docstring for the
    reference's off-by-one on non-uniform allocations)."""
    c = np.asarray(centroids_num, dtype=np.int64)
    return np.concatenate([[0], np.cumsum(c)[:-1]])


def find_frequent_patterns(codebook: np.ndarray, min_support: int,
                           centroids_num: Sequence[int],
                           ) -> Dict[FrozenSet[int], int]:
    """Reference ``findFrequentPattern`` (``Experiment.hpp:15-18``): treat
    each code row as a transaction of offset items and mine it."""
    codes = np.asarray(codebook)
    offs = subspace_offsets(centroids_num)
    if codes.ndim != 2 or codes.shape[1] != len(offs):
        raise ValueError(f"codebook shape {codes.shape} does not match "
                         f"{len(offs)} subspaces")
    items = codes.astype(np.int64) + offs[None, :]
    return fptree_growth(items.tolist(), min_support)


def filter_patterns(patterns: Dict[FrozenSet[int], int],
                    min_size: int = 2, maximal_only: bool = True,
                    ) -> List[Pattern]:
    """The demo's post-filter (``demo_vaq.cpp:141-188``): drop patterns
    smaller than ``min_size``, drop patterns that are strict subsets of a
    larger surviving pattern, sort by descending support."""
    kept = [(p, c) for p, c in patterns.items() if len(p) >= min_size]
    if maximal_only:
        larger = sorted(kept, key=lambda pc: -len(pc[0]))
        out = []
        for p, c in kept:
            if any(len(q) > len(p) and p < q for q, _ in larger):
                continue
            out.append((p, c))
        kept = out
    return sorted(kept, key=lambda pc: (-pc[1], sorted(pc[0])))
