"""Item cooccurrence counting (own copy of
``predictionio_tpu/ops/cooccurrence.py``).

Reference parity: ``examples/scala-parallel-similarproduct/
multi-events-multi-algos/src/main/scala/CooccurrenceAlgorithm.scala:30-90``
— distinct (user, item) interactions, per-user ordered item pairs, pair
counts, top-N cooccurring items kept per item. Host code: the port does not
build the JAX package's native library, so it takes that module's scipy
formulation, ``A.T @ A`` over the distinct binary user x item matrix.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def cooccurrence_top_n(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    n_items: int,
    top_n: int,
) -> dict[int, list[tuple[int, int]]]:
    """Returns item -> [(other_item, count)] sorted by count descending,
    then item ascending, at most ``top_n`` long. With A the distinct binary
    user x item interaction matrix, ``A.T @ A`` is the full cooccurrence
    count matrix (diagonal = item popularity, zeroed out)."""
    from scipy import sparse

    u = np.asarray(user_idx, np.int64)
    it = np.asarray(item_idx, np.int64)
    if len(u) == 0:
        return {}
    # distinct (user, item) via 1-D codes (np.unique(axis=0) sorts
    # structured voids, about 50x slower at ML-1M scale)
    codes = np.unique(u * n_items + it)
    users, items = codes // n_items, codes % n_items
    n_users = int(users.max()) + 1
    A = sparse.csr_matrix(
        (np.ones(len(users), np.int64), (users, items)),
        shape=(n_users, n_items),
    )
    C = (A.T @ A).tocsr()
    C.setdiag(0)
    C.eliminate_zeros()
    out: dict[int, list[tuple[int, int]]] = {}
    indptr, indices, data = C.indptr, C.indices, C.data
    for item in range(n_items):
        lo, hi = indptr[item], indptr[item + 1]
        if lo == hi:
            continue
        row_items = indices[lo:hi]
        row_counts = data[lo:hi]
        order = np.lexsort((row_items, -row_counts))[:top_n]
        out[int(item)] = [(int(row_items[j]), int(row_counts[j])) for j in order]
    return out


def _cooccurrence_top_n_reference(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    n_items: int,
    top_n: int,
) -> dict[int, list[tuple[int, int]]]:
    """Direct pair-expansion formulation kept as the oracle for tests."""
    pairs = np.unique(
        np.stack([np.asarray(user_idx, np.int64), np.asarray(item_idx, np.int64)], 1),
        axis=0,
    )
    users, items = pairs[:, 0], pairs[:, 1]
    order = np.argsort(users, kind="stable")
    users, items = users[order], items[order]
    boundaries = np.flatnonzero(np.diff(users)) + 1
    groups = np.split(items, boundaries)
    codes: list[np.ndarray] = []
    for g in groups:
        if len(g) < 2:
            continue
        a, b = np.meshgrid(g, g, indexing="ij")
        mask = a != b
        codes.append(a[mask] * n_items + b[mask])
    if not codes:
        return {}
    counts = np.bincount(np.concatenate(codes), minlength=0)
    nz = np.flatnonzero(counts)
    out: dict[int, list[tuple[int, int]]] = {}
    lhs = nz // n_items
    rhs = nz % n_items
    cnt = counts[nz]
    order = np.lexsort((-cnt, lhs))
    for i in order:
        item = int(lhs[i])
        bucket = out.setdefault(item, [])
        if len(bucket) < top_n:
            bucket.append((int(rhs[i]), int(cnt[i])))
    return out


def score_by_cooccurrence(
    top_map: dict[int, list[tuple[int, int]]],
    query_items: Sequence[int],
) -> dict[int, float]:
    """Sum cooccurrence counts over the query items (ref predict :70-90)."""
    scores: dict[int, float] = {}
    for qi in query_items:
        for item, count in top_map.get(qi, []):
            scores[item] = scores.get(item, 0.0) + count
    return scores
