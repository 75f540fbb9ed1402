"""BiMap: bidirectional string↔int index mapping — own copy of the
reference's ``predictionio_tpu/data/bimap.py``.

The bridge from entity-id strings to dense factor rows; construction is
deterministic (order of first appearance).
"""

from __future__ import annotations

from typing import Generic, Hashable, Iterable, Iterator, Mapping, Optional, Sequence, TypeVar

import numpy as np

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


def compress_codes(idx: np.ndarray, bimap: "BiMap") -> tuple:
    """Re-code `idx` densely over the entities it actually uses. Returns
    `(new_idx int32, new_bimap)` — the original pair when already dense.
    Sorted-unique keeps BiMap order deterministic."""
    uniq, inv = np.unique(idx, return_inverse=True)
    if len(uniq) == len(bimap):
        return np.asarray(idx, dtype=np.int32), bimap
    return (inv.astype(np.int32),
            BiMap.string_int(bimap.from_index(uniq)))


class BiMap(Generic[K, V]):
    """An immutable one-to-one mapping with O(1) forward and inverse lookup."""

    def __init__(self, forward: Mapping[K, V]):
        self._fwd: dict[K, V] = dict(forward)
        self._inv: dict[V, K] = {v: k for k, v in self._fwd.items()}
        if len(self._inv) != len(self._fwd):
            raise ValueError("BiMap values must be unique.")

    @classmethod
    def string_int(cls, keys: Iterable[K]) -> "BiMap[K, int]":
        """Assign dense indices 0..n-1 in order of first appearance."""
        fwd: dict[K, int] = {}
        for k in keys:
            if k not in fwd:
                fwd[k] = len(fwd)
        return BiMap(fwd)

    string_long = string_int

    def __getitem__(self, key: K) -> V:
        return self._fwd[key]

    def get(self, key: K, default: Optional[V] = None) -> Optional[V]:
        return self._fwd.get(key, default)

    def contains(self, key: K) -> bool:
        return key in self._fwd

    __contains__ = contains

    def inverse(self) -> "BiMap[V, K]":
        inv = getattr(self, "_inverse_bimap", None)
        if inv is None:
            inv = BiMap(self._inv)
            self._inverse_bimap = inv  # the serving path calls per query
        return inv

    def to_index(self, keys: Sequence[K]) -> np.ndarray:
        """Vectorized forward lookup → int32 array (raises on unknown key)."""
        return np.asarray([self._fwd[k] for k in keys], dtype=np.int32)

    def from_index(self, idx: Sequence[int]) -> list[K]:
        return [self._inv[int(i)] for i in idx]

    def __len__(self) -> int:
        return len(self._fwd)

    def __iter__(self) -> Iterator[K]:
        return iter(self._fwd)

    def items(self):
        return self._fwd.items()

    def keys(self):
        return self._fwd.keys()

    def values(self):
        return self._fwd.values()

    def to_dict(self) -> dict[K, V]:
        return dict(self._fwd)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BiMap) and self._fwd == other._fwd

    def __repr__(self) -> str:
        preview = dict(list(self._fwd.items())[:4])
        return f"BiMap({len(self._fwd)} entries, {preview!r}...)"
