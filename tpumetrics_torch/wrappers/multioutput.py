"""MultioutputWrapper (port of ``tpumetrics/wrappers/multioutput.py``).

``remove_nans=True`` (the default) drops the rows holding a NaN before each
inner update by boolean indexing: a shape that depends on the data, so on a
card every update reads the host once per output, and no CUDA graph can
hold it. These are the JAX package's semantics, whose functional bridge
refuses the option; construct with ``remove_nans=False`` for an update
free of host reads.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, Dict, List, Tuple

import torch

from tpumetrics_torch.metric import Metric
from tpumetrics_torch.utils.exceptions import TPUMetricsUserError
from tpumetrics_torch.wrappers.abstract import WrapperMetric

Tensor = torch.Tensor


def _get_nan_indices(*tensors: Tensor) -> Tensor:
    """Rows where any of the tensors holds a NaN."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    nan_idxs = torch.zeros(len(tensors[0]), dtype=torch.bool, device=tensors[0].device)
    for tensor in tensors:
        nan_idxs = nan_idxs | torch.isnan(tensor.reshape(len(tensor), -1)).any(dim=1)
    return nan_idxs


class MultioutputWrapper(WrapperMetric):
    """One copy of a metric per output column (for example per-target R2 or MAE).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.wrappers import MultioutputWrapper
        >>> from tpumetrics_torch.regression import R2Score
        >>> target = torch.tensor([[0.5, 1.0], [-1.0, 1.0], [7.0, -6.0]])
        >>> preds = torch.tensor([[0.25, 0.5], [-1.0, 1.0], [8.0, -5.0]])
        >>> r2 = MultioutputWrapper(R2Score(device="cpu"), num_outputs=2)
        >>> r2.update(preds, target)
        >>> [round(float(x), 4) for x in r2.compute()]
        [0.9706, 0.9617]
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**{"device": base_metric.device, **kwargs})
        self.metrics = [deepcopy(base_metric) for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple[List[Any], Dict[str, Any]]]:
        """Every tensor input cut down to one output column, per output.
        The column is a view (``narrow``); nothing is copied to the card."""
        out = []
        for i in range(len(self.metrics)):

            def _select(x: Any) -> Any:
                return x.narrow(self.output_dim, i, 1) if isinstance(x, Tensor) else x

            selected_args = [_select(a) for a in args]
            selected_kwargs = {k: _select(v) for k, v in kwargs.items()}
            if self.remove_nans:
                nan_idxs = _get_nan_indices(*selected_args, *selected_kwargs.values())
                selected_args = [arg[~nan_idxs] for arg in selected_args]
                selected_kwargs = {k: v[~nan_idxs] for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [arg.squeeze(self.output_dim) for arg in selected_args]
                selected_kwargs = {k: v.squeeze(self.output_dim) for k, v in selected_kwargs.items()}
            out.append((selected_args, selected_kwargs))
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Route each output column into its own copy of the metric."""
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs)):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> Tensor:
        """The per-output results, stacked."""
        return torch.stack([m.compute() for m in self.metrics], 0)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Per-output forwards, stacked (each copy accumulates as in ``update``)."""
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs))
        ]
        if results[0] is None:
            return None
        return torch.stack(results, 0)

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
        super().reset()

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self.metrics[0]._filter_kwargs(**kwargs)

    # ------------------------------------------------------ functional bridge
    # a list of per-output states; needs remove_nans=False (dropping NaN
    # rows gives shapes that depend on the data)

    def _require_static_shapes(self) -> None:
        if self.remove_nans:
            raise TPUMetricsUserError(
                "MultioutputWrapper's functional bridge requires remove_nans=False: NaN-row removal selects a"
                " data-dependent number of rows. Construct with remove_nans=False (and drop NaNs before the"
                " update if needed)."
            )

    def init_state(self) -> List[Any]:
        self._require_static_shapes()
        return [m.init_state() for m in self.metrics]

    def functional_update(self, state: List[Any], *args: Any, **kwargs: Any) -> List[Any]:
        self._require_static_shapes()
        return [
            m.functional_update(st, *sel_args, **sel_kwargs)
            for m, st, (sel_args, sel_kwargs) in zip(self.metrics, state, self._get_args_kwargs_by_output(*args, **kwargs))
        ]

    def functional_compute(self, state: List[Any], axis_name: Any = None, backend: Any = None) -> Tensor:
        return torch.stack(
            [m.functional_compute(st, axis_name=axis_name, backend=backend) for m, st in zip(self.metrics, state)], 0
        )

    def _sync_state_collect(self, state: List[Any], backend: Any, reducer: Any, group: Any = None) -> Callable[[], List[Any]]:
        finalizers = [m._sync_state_collect(st, backend, reducer, group) for m, st in zip(self.metrics, state)]
        return lambda: [fin() for fin in finalizers]

    functional_forward = Metric.functional_forward
    sync_state = Metric.sync_state
