"""Delta tier: append-only vector/interval buffer with tombstones.

New objects land here between compactions. The buffer has a *static padded
capacity* so the device view (a ``DeltaSegment``) keeps one shape across
epochs, and it is searched by a masked brute-force scan through the same
gather scorer (``ops.filter_dist_gather``, B3) as graph-tier edges.

The interval predicate for delta objects cannot use the compacted tier's
canonical rank grids — delta endpoint values are off-grid by definition, and
snapping them would silently mis-classify objects between adjacent canonical
values. Instead the predicate is evaluated in **monotone float-key space**:
``sort_key`` maps float32 to int32 such that ``key(u) <= key(v)`` iff
``u <= v``, so the kernel's integer rectangle test
``l <= a <= r and b <= c <= e`` with per-slot ``r = key(X_i)``,
``b = key(Y_i)`` and per-query state ``(a, c) = (key(x_q), key(y_q))``
evaluates ``X_i >= x_q and Y_i <= y_q`` (Eq. 1) exactly up to float32
rounding of the transformed coordinates.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.predicates import RelationMapping
from repro_torch.search.device_graph import DeltaSegment

INT32_MIN = np.int32(np.iinfo(np.int32).min)
INT32_MAX = np.int32(np.iinfo(np.int32).max)


def sort_key(values: np.ndarray | float) -> np.ndarray:
    """Monotone float32 -> int32 key (IEEE-754 total-order trick).

    Adding 0.0 first normalizes -0.0 to +0.0 so the two zeros get equal keys.
    """
    v = np.asarray(values, dtype=np.float32) + np.float32(0.0)
    bits = v.view(np.int32)
    return np.where(bits < 0, bits ^ np.int32(0x7FFFFFFF), bits)


def query_key_state(rel: RelationMapping, s_q: np.ndarray, t_q: np.ndarray) -> np.ndarray:
    """Per-query delta-tier state [B, 2] int32: (key(x_q), key(y_q))."""
    x_q, y_q = rel.query_map(
        np.asarray(s_q, dtype=np.float64), np.asarray(t_q, dtype=np.float64)
    )
    return np.stack(
        [np.atleast_1d(sort_key(x_q)), np.atleast_1d(sort_key(y_q))], axis=1
    ).astype(np.int32)


class DeltaBuffer:
    """Append-only (vector, interval) buffer with live flags.

    Slots are written once (monotone ``size``) and logically removed by
    clearing ``live`` — the device view masks dead slots with id -1, which
    the scorer turns into +inf.
    """

    def __init__(self, dim: int, capacity: int, rel: RelationMapping):
        self.dim = dim
        self.capacity = capacity
        self.rel = rel
        self.vectors = np.zeros((capacity, dim), dtype=np.float32)
        self.s = np.zeros(capacity, dtype=np.float64)
        self.t = np.zeros(capacity, dtype=np.float64)
        self.labels = np.zeros((capacity, 4), dtype=np.int32)
        self.labels[:, 0] = 1  # l > r: empty rectangle until written
        self.ext_ids = np.full(capacity, -1, dtype=np.int64)
        self.live = np.zeros(capacity, dtype=bool)
        self.size = 0

    @property
    def live_count(self) -> int:
        return int(np.count_nonzero(self.live[: self.size]))

    @property
    def full(self) -> bool:
        return self.size >= self.capacity

    def append(self, vec: np.ndarray, s: float, t: float, ext_id: int) -> int:
        """Write one object; returns its slot. Caller checks ``full`` first."""
        if self.full:
            raise RuntimeError("delta buffer full; compact first")
        i = self.size
        self.vectors[i] = np.asarray(vec, dtype=np.float32)
        self.s[i] = s
        self.t[i] = t
        X, Y = self.rel.transform_data(
            np.asarray([s], dtype=np.float64), np.asarray([t], dtype=np.float64)
        )
        self.labels[i, 0] = INT32_MIN
        self.labels[i, 1] = sort_key(X[0])
        self.labels[i, 2] = sort_key(Y[0])
        self.labels[i, 3] = INT32_MAX
        self.ext_ids[i] = ext_id
        self.live[i] = True
        self.size = i + 1
        return i

    def tombstone(self, slot: int) -> None:
        self.live[slot] = False

    def live_slots(self, *, upto: int | None = None) -> np.ndarray:
        hi = self.size if upto is None else upto
        return np.flatnonzero(self.live[:hi])

    def device_segment(self) -> DeltaSegment:
        """Snapshot the full-capacity device view (static shape)."""
        ids = np.where(self.live, np.arange(self.capacity), -1).astype(np.int32)
        return DeltaSegment(
            vectors=self.vectors.copy(),
            labels=self.labels.copy(),
            slot_ids=ids,
            ext_ids=np.where(self.live, self.ext_ids, -1).astype(np.int32),
        )
