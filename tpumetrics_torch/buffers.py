"""Fixed-capacity masked buffers: "cat"-style list states of static shape
(counterpart of ``tpumetrics/buffers.py``).

A :class:`MaskedBuffer` is a preallocated ``values`` tensor of shape
``(capacity, *feature)`` and an int32 ``count`` of the leading rows that
hold data (``requested`` counts every row ever asked for, so an overflow
stays visible). Appending writes a batch at offset ``count`` with one
``index_copy``: rows masked out by ``valid`` and rows past the capacity go
to a dump row past the end, which is cut off. No step reads the device from
the host, so an append on a CUDA buffer never waits for the card. Syncing
gathers every rank's values and counts and compacts them into one buffer;
:func:`materialize` gives the exact rows.

Overflow: rows beyond ``capacity`` are dropped. Size ``capacity`` to the
most rows the state will hold; :func:`buffer_overflowed` says whether any
were dropped.
"""

from __future__ import annotations

from typing import Any, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor


class MaskedBuffer(NamedTuple):
    """Fixed-capacity masked accumulation buffer."""

    values: Tensor  # (capacity, *feature)
    count: Tensor  # () int32: number of valid leading rows
    requested: Tensor  # () int32: rows ever requested (== count unless overflowed)

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    def valid_mask(self) -> Tensor:
        """Boolean ``(capacity,)`` mask of the rows holding data."""
        return torch.arange(self.capacity, device=self.values.device) < self.count


def create_buffer(
    capacity: int,
    feature_shape: Tuple[int, ...] = (),
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
) -> MaskedBuffer:
    """Fresh empty buffer of shape ``(capacity, *feature_shape)``."""
    return MaskedBuffer(
        values=torch.zeros((capacity, *feature_shape), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        requested=torch.zeros((), dtype=torch.int32, device=device),
    )


def _scatter_rows(out_rows: int, rows: Tensor, pos: Tensor) -> Tensor:
    """``rows`` written at ``pos`` into ``out_rows`` zero rows; positions
    equal to ``out_rows`` land in a dump row that is cut off (torch has no
    scatter that drops out-of-range indices)."""
    out = rows.new_zeros((out_rows + 1, *rows.shape[1:]))
    return out.index_copy_(0, pos.to(torch.int64), rows)[:out_rows]


def buffer_append(buf: MaskedBuffer, batch: Any, valid: Optional[Tensor] = None) -> MaskedBuffer:
    """Append the rows of ``batch`` (where ``valid``, if given) at the write offset.

    Rows masked out, and rows past the capacity, are routed to the dump row.
    """
    values = buf.values
    batch = torch.as_tensor(batch, dtype=values.dtype, device=values.device)
    if batch.ndim == values.ndim - 1:
        batch = batch[None]  # a single row
    cap = buf.capacity
    if valid is None:
        valid = torch.ones((batch.shape[0],), dtype=torch.bool, device=values.device)
    valid = valid.to(torch.bool)
    ones = valid.to(torch.int32)
    pos = torch.where(valid, buf.count + torch.cumsum(ones, 0, dtype=torch.int32) - 1, cap).clamp(max=cap)
    # one copy of the buffer with the dump row below it; valid rows land on distinct rows >= count
    grown = torch.cat([values, values.new_zeros((1, *values.shape[1:]))])
    new_values = grown.index_copy_(0, pos.to(torch.int64), batch)[:cap]
    n_new = ones.sum(dtype=torch.int32)
    return MaskedBuffer(
        values=new_values,
        count=torch.clamp(buf.count + n_new, max=cap),
        requested=buf.requested + n_new,
    )


def buffer_append_bucketed(buf: MaskedBuffer, padded: Tensor, n_valid: Any) -> MaskedBuffer:
    """Append the first ``n_valid`` rows of a batch padded to a bucket size."""
    padded = torch.as_tensor(padded, device=buf.values.device)
    valid = torch.arange(padded.shape[0], device=padded.device) < torch.as_tensor(n_valid, device=padded.device)
    return buffer_append(buf, padded, valid=valid)


def buffer_extend(buf: MaskedBuffer, other: MaskedBuffer) -> MaskedBuffer:
    """Append another buffer's valid rows. Rows the source had already
    dropped stay counted in ``requested``, so a merge cannot hide an overflow."""
    merged = buffer_append(buf, other.values, valid=other.valid_mask())
    return merged._replace(requested=buf.requested + other.requested)


def buffer_compact(stacked_values: Tensor, counts: Tensor) -> MaskedBuffer:
    """Compact per-rank buffers ``(W, cap, *f)`` with valid ``counts`` ``(W,)``
    into one ``(W*cap, *f)`` buffer, rank by rank."""
    w, cap = stacked_values.shape[0], stacked_values.shape[1]
    dev = stacked_values.device
    counts = counts.to(torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    idx = torch.arange(cap, device=dev)
    total = w * cap
    pos = torch.where(idx[None, :] < counts[:, None], offsets[:, None] + idx[None, :], total)
    out = _scatter_rows(total, stacked_values.reshape((total, *stacked_values.shape[2:])), pos.reshape(-1))
    count = counts.sum(dtype=torch.int32)
    return MaskedBuffer(values=out, count=count, requested=count)


def buffer_all_gather(buf: MaskedBuffer, backend: Any, group: Optional[Any] = None) -> MaskedBuffer:
    """Gather a buffer from every rank through a sync backend and compact it:
    two gathers, of the values and of the packed (count, requested).

    Both are reported to the collective ledger as logical ``"buffer_gather"``
    records (``source="reducer"``, as a fused flush reports its classes), so
    a buffer keeps its attribution through any backend; an instrumented
    backend records its wire calls beside them."""
    from tpumetrics_torch.parallel.backend import dtype_name
    from tpumetrics_torch.telemetry import ledger as _telemetry

    packed = torch.stack([buf.count, buf.requested]).to(torch.int32)
    if _telemetry.recording():
        for arr in (buf.values, packed):
            _telemetry.record_collective(
                backend, "buffer_gather", "gather", tuple(arr.shape), dtype_name(arr.dtype), arr.element_size(),
                int(backend.world_size()), source="reducer", capacity=buf.capacity,
            )
    vals = backend.all_gather(buf.values, group)
    meta = torch.stack([m.reshape(2) for m in backend.all_gather(packed, group)])  # (W, 2)
    merged = buffer_compact(torch.stack(list(vals)), meta[:, 0])
    return merged._replace(requested=meta[:, 1].sum(dtype=torch.int32))


def buffer_merge(bufs: Sequence[MaskedBuffer]) -> MaskedBuffer:
    """Merge same-capacity per-rank buffers in one process."""
    merged = buffer_compact(torch.stack([b.values for b in bufs]), torch.stack([b.count.reshape(()) for b in bufs]))
    requested = torch.stack([b.requested.reshape(()) for b in bufs]).sum(dtype=torch.int32)
    return merged._replace(requested=requested)


def buffer_overflowed(buf: MaskedBuffer) -> Tensor:
    """True when rows were dropped because the capacity was exceeded."""
    return buf.requested > buf.count


def materialize(buf: MaskedBuffer) -> Tensor:
    """The exact rows ``values[:count]`` (reads ``count`` on the host)."""
    return buf.values[: int(buf.count)]


def masked_values(
    state: Any, feature_shape: Tuple[int, ...] = (), dtype: torch.dtype = torch.float32
) -> Tuple[Tensor, Tensor]:
    """Uniform ``(values, valid_mask)`` view of a cat-style state: a list of
    tensors (every row valid), a MaskedBuffer, or a tensor.

    ``feature_shape``/``dtype`` shape the zero-row result of an empty list,
    which carries no shape of its own."""
    from tpumetrics_torch.utils.data import dim_zero_cat

    if isinstance(state, _BufferList):
        state = state.buffer
    if isinstance(state, MaskedBuffer):
        return state.values, state.valid_mask()
    if isinstance(state, list):
        if not state:
            return torch.zeros((0, *feature_shape), dtype=dtype), torch.zeros((0,), dtype=torch.bool)
        cat = dim_zero_cat(state)
        return cat, torch.ones((cat.shape[0],), dtype=torch.bool, device=cat.device)
    if isinstance(state, Tensor):
        return state, torch.ones((state.shape[0],), dtype=torch.bool, device=state.device)
    raise TypeError(f"Unsupported cat-state type {type(state)}")


class _BufferList:
    """List-like adapter, so ``update`` code written for list states
    (``self.preds.append(x)``) drives a MaskedBuffer state."""

    __slots__ = ("buffer",)

    def __init__(self, buffer: MaskedBuffer) -> None:
        self.buffer = buffer

    def append(self, x: Tensor, valid: Optional[Tensor] = None) -> None:
        self.buffer = buffer_append(self.buffer, x, valid=valid)

    def __iter__(self) -> Iterator[Tensor]:
        return iter([materialize(self.buffer)])

    def __len__(self) -> int:
        return 1


__all__: List[str] = [
    "MaskedBuffer",
    "buffer_all_gather",
    "buffer_append",
    "buffer_append_bucketed",
    "buffer_compact",
    "buffer_extend",
    "buffer_merge",
    "buffer_overflowed",
    "create_buffer",
    "masked_values",
    "materialize",
]
