"""BiMap — immutable bidirectional mapping, used to index entity IDs into
contiguous integer ranges for device embedding/factor tables (the port's
own copy of ``predictionio_tpu/data/bimap.py``).

Reference parity: ``data/.../storage/BiMap.scala:1-266`` (``stringInt``/
``stringLong`` constructors, ``inverse``, ``contains``, ``getOrElse``,
``take``, ``toMap``). Where the reference builds from Spark RDDs, this builds
from any iterable (host-side) — the resulting dense int range is exactly what
device-side gather/scatter wants.
"""

from __future__ import annotations

from typing import Generic, Hashable, Iterable, Iterator, Mapping, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class BiMap(Generic[K, V]):
    __slots__ = ("_forward", "_backward")

    def __init__(self, forward: Mapping[K, V], _backward: Mapping[V, K] | None = None):
        self._forward: dict[K, V] = dict(forward)
        if _backward is None:
            backward: dict[V, K] = {v: k for k, v in self._forward.items()}
            if len(backward) != len(self._forward):
                raise ValueError("BiMap values must be unique")
            self._backward = backward
        else:
            self._backward = dict(_backward)

    # -- constructors (ref BiMap.scala stringInt/stringLong) ----------------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Assign each distinct key a dense index 0..n-1 in first-seen order."""
        forward: dict[str, int] = {}
        for k in keys:
            if k not in forward:
                forward[k] = len(forward)
        return BiMap(forward)

    string_long = string_int  # Python ints are unbounded

    # -- API ----------------------------------------------------------------
    def __call__(self, key: K) -> V:
        return self._forward[key]

    def __getitem__(self, key: K) -> V:
        return self._forward[key]

    def __contains__(self, key: object) -> bool:
        return key in self._forward

    def __len__(self) -> int:
        return len(self._forward)

    def __iter__(self) -> Iterator[K]:
        return iter(self._forward)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BiMap) and self._forward == other._forward

    def get(self, key: K, default: V | None = None) -> V | None:
        return self._forward.get(key, default)

    def get_or_else(self, key: K, default: V) -> V:
        return self._forward.get(key, default)

    def contains(self, key: K) -> bool:
        return key in self._forward

    def inverse(self) -> "BiMap[V, K]":
        return BiMap(self._backward, self._forward)

    def take(self, n: int) -> "BiMap[K, V]":
        head = dict(list(self._forward.items())[:n])
        return BiMap(head)

    def to_map(self) -> dict[K, V]:
        return dict(self._forward)

    def __repr__(self) -> str:
        return f"BiMap({len(self._forward)} entries)"
