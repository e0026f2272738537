"""Power-of-two shape bucketing, a private copy of the three helpers of
``tpumetrics/runtime/bucketing.py`` that detection needs (``pow2_at_least``,
``pow2_bucket_edges``, ``ShapeBucketer``). They move to the port's
streaming runtime when that is ported."""

from __future__ import annotations

from typing import List, Sequence, Tuple


def pow2_at_least(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    e = max(int(floor), 1)
    while e < n:
        e *= 2
    return e


def pow2_bucket_edges(max_size: int, min_size: int = 1) -> Tuple[int, ...]:
    """Power-of-two bucket edges ``min_size..>=max_size`` (each edge doubles)."""
    if min_size <= 0 or max_size < min_size:
        raise ValueError(f"Need 0 < min_size <= max_size, got {min_size}, {max_size}")
    edges: List[int] = []
    e = 1
    while e < min_size:
        e *= 2
    while True:
        edges.append(e)
        if e >= max_size:
            break
        e *= 2
    return tuple(edges)


class ShapeBucketer:
    """Maps ragged sizes onto a fixed set of padded sizes: ``n`` pads to the
    smallest edge ``>= n``.

    Args:
        edges: strictly increasing bucket sizes.
    """

    def __init__(self, edges: Sequence[int]) -> None:
        edges = tuple(int(e) for e in edges)
        if not edges:
            raise ValueError("Need at least one bucket edge")
        if any(e <= 0 for e in edges) or list(edges) != sorted(set(edges)):
            raise ValueError(f"Bucket edges must be strictly increasing positives, got {edges}")
        self.edges = edges

    def bucket_for(self, n: int) -> int:
        """Smallest edge >= n."""
        if n <= 0:
            raise ValueError(f"Batch must be non-empty, got {n} rows")
        for e in self.edges:
            if n <= e:
                return e
        raise ValueError(f"Size {n} exceeds the largest bucket edge {self.edges[-1]}")
