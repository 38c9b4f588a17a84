"""Item cooccurrence counting (own copy of
``predictionio_tpu/ops/cooccurrence.py``).

Reference parity: ``examples/scala-parallel-similarproduct/
multi-events-multi-algos/src/main/scala/CooccurrenceAlgorithm.scala:30-90``
— distinct (user, item) interactions, per-user ordered item pairs, pair
counts, top-N cooccurring items kept per item. Host code, as in the JAX
package: the host library's dense-row count and top-N select
(``utils/native.cooccur_topn``), and past 2^28 cells of that dense matrix
the scipy formulation, ``A.T @ A`` over the distinct binary user x item
matrix.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from predictionio_tpu_torch.utils import native


def cooccurrence_top_n(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    n_items: int,
    top_n: int,
) -> dict[int, list[tuple[int, int]]]:
    """Returns item -> [(other_item, count)] sorted by count descending,
    then item ascending, at most ``top_n`` long: the host library's count
    and select, or, for a vocabulary too large for its dense matrix, the
    scipy formulation (``_cooccurrence_top_n_scipy``)."""
    u = np.asarray(user_idx, np.int64)
    it = np.asarray(item_idx, np.int64)
    if len(u) == 0:
        return {}
    # distinct (user, item) via 1-D codes (np.unique(axis=0) sorts
    # structured voids, about 50x slower at ML-1M scale). The sorted codes
    # come back grouped by user with items ascending within a user: the
    # host library's input contract.
    codes = np.unique(u * n_items + it)
    users, items = codes // n_items, codes % n_items
    dense = native.cooccur_topn(users, items, n_items, top_n)
    if dense is None:
        return _cooccurrence_top_n_scipy(users, items, n_items, top_n)
    out_items, out_counts = dense
    n_valid = (out_items >= 0).sum(axis=1)  # -1 padding is a tail
    items_l, counts_l = out_items.tolist(), out_counts.tolist()
    return {item: list(zip(items_l[item][:nv], counts_l[item][:nv]))
            for item, nv in enumerate(n_valid.tolist()) if nv}


def _cooccurrence_top_n_scipy(
    users: np.ndarray, items: np.ndarray, n_items: int, top_n: int
) -> dict[int, list[tuple[int, int]]]:
    """With A the distinct binary user x item interaction matrix, ``A.T @
    A`` is the full cooccurrence count matrix (diagonal = item popularity,
    zeroed out). ``users``/``items`` are the distinct pairs."""
    from scipy import sparse

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
