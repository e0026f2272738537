"""RetrievalMetric base (port of ``tpumetrics/retrieval/base.py``).

``compute`` ranks every query at once with
:func:`~tpumetrics_torch.functional.retrieval._grouped.sort_queries` (two
stable sorts and segment sums over all queries) and reduces the per-query
values with the empty-target policy.

The states are three list states: int32 ``indexes`` and float32 ``preds``
and ``target``. Declare a capacity for each with ``set_state_capacity`` and
the functional path (``init_state``) holds them in fixed-capacity
:class:`~tpumetrics_torch.buffers.MaskedBuffer` states; a metric whose live
states are such buffers (installed with ``interop.load_state``) appends to
them in its eager update too, with no host read but the binary-target
check, and a fused collection captures it. Give such a metric
``num_queries``, so that ``compute()`` need not read the largest index.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Optional, Tuple

import torch

from tpumetrics_torch.buffers import _BufferList
from tpumetrics_torch.functional.retrieval._grouped import SortedQueries, reduce_queries, sort_queries
from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.checks import _check_retrieval_inputs, _is_capturing
from tpumetrics_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class RetrievalMetric(Metric, ABC):
    """Base for query-grouped retrieval metrics fed ``(preds, target, indexes)``.

    Args:
        empty_target_action: policy for queries without the required target
            (``neg``: count 0.0; ``pos``: count 1.0; ``skip``: exclude;
            ``error``: raise).
        ignore_index: target value whose rows are dropped: a list state's
            append drops them (a boolean selection, which reads the host),
            a MaskedBuffer routes them to its dump row.
        num_queries: the number of queries, ids ``0..num_queries-1``;
            inferred from the largest index in ``compute()`` otherwise (one
            host read).
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    indexes: List[Tensor]
    preds: List[Tensor]
    target: List[Tensor]

    allow_non_binary_target: bool = False
    _empty_requirement: str = "positive"

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        num_queries: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action

        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index
        self.num_queries = num_queries

        self.add_state("indexes", default=[], dist_reduce_fx=None, feature_dtype=torch.int32)
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

    @property
    def _update_reads_host(self) -> bool:  # type: ignore[override]
        """An update that drops ``ignore_index`` rows from list states reads
        the mask on the host; a fused collection keeps such a metric eager."""
        return self.ignore_index is not None and isinstance(self.indexes, list)

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        """Validate, flatten, and append the rows (but the ``ignore_index`` ones)."""
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target, keep = _check_retrieval_inputs(
            indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target,
            ignore_index=self.ignore_index,
        )
        self._append_state("indexes", indexes, valid=keep)
        self._append_state("preds", preds, valid=keep)
        self._append_state("target", target, valid=keep)

    def _flat_state(self) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor], int]:
        """(indexes, preds, target, valid_mask, num_queries) from the state."""
        if isinstance(self.indexes, _BufferList):
            idx = self.indexes.buffer.values
            preds = self.preds.buffer.values
            target = self.target.buffer.values
            mask = self.indexes.buffer.valid_mask()
        else:
            dev = self.device
            idx = dim_zero_cat(self.indexes) if self.indexes else torch.zeros((0,), dtype=torch.int32, device=dev)
            preds = dim_zero_cat(self.preds) if self.preds else torch.zeros((0,), dtype=torch.float32, device=dev)
            target = dim_zero_cat(self.target) if self.target else torch.zeros((0,), dtype=torch.float32, device=dev)
            mask = None

        num_queries = self.num_queries
        if num_queries is None:
            if _is_capturing():
                raise ValueError(
                    "Retrieval metrics need `num_queries` to compute in a CUDA graph capture;"
                    " pass num_queries= at construction or compute eagerly."
                )
            valid_idx = idx if mask is None else idx[mask]
            num_queries = int(valid_idx.max()) + 1 if valid_idx.numel() else 1
        return idx, preds, target, mask, num_queries

    def compute(self) -> Tensor:
        """Rank every query and reduce the per-query scores with the
        empty-target policy."""
        idx, preds, target, mask, num_queries = self._flat_state()
        if idx.shape[0] == 0:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        sq = sort_queries(idx, preds, target, num_queries, mask)
        values, computable = self._grouped_metric(sq)
        return reduce_queries(values, computable, sq.counts > 0, self.empty_target_action, self._empty_requirement)

    @abstractmethod
    def _grouped_metric(self, sq: SortedQueries) -> Tuple[Tensor, Tensor]:
        """Per-query (values, computable) for all queries at once."""
