"""BootStrapper (port of ``tpumetrics/wrappers/bootstrapping.py``).

The resample indices are drawn on the host from a numpy
``np.random.default_rng(seed)``, as in the JAX package, so one seed gives
the same resamples in both packages. Each update copies each copy's
indices to the metric's device once: a copy from pageable host memory,
which waits for the device (a host sync on a card).
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from tpumetrics_torch.metric import Metric
from tpumetrics_torch.wrappers.abstract import WrapperMetric

Tensor = torch.Tensor


def _bootstrap_sampler(
    size: int, sampling_strategy: str = "poisson", rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Indices ``0..size-1`` resampled with replacement."""
    rng = rng or np.random.default_rng()
    if sampling_strategy == "poisson":
        n = rng.poisson(1.0, size=size)
        return np.repeat(np.arange(size), n)
    if sampling_strategy == "multinomial":
        return rng.integers(0, size, size=size)
    raise ValueError("Unknown sampling strategy")


class BootStrapper(WrapperMetric):
    """Bootstrapped statistics of any metric: ``num_bootstraps`` copies, each
    fed a resampled view (rows drawn with replacement) of every batch.

    Args:
        base_metric: the metric to bootstrap.
        num_bootstraps: the number of resampled copies.
        mean, std, quantile, raw: which statistics ``compute`` returns.
        sampling_strategy: ``"multinomial"`` (the default: each resample has
            the batch's size) or ``"poisson"`` (each row repeated a
            Poisson(1) number of times).
        seed: the seed of the numpy generator of the resamples.

    Example:
        >>> import torch
        >>> from tpumetrics_torch.wrappers import BootStrapper
        >>> from tpumetrics_torch.classification import MulticlassAccuracy
        >>> metric = BootStrapper(MulticlassAccuracy(num_classes=5, device="cpu"), num_bootstraps=20, seed=42)
        >>> metric.update(torch.tensor([0, 1, 2, 3, 4, 0, 1, 2, 3, 4]), torch.tensor([0, 1, 2, 3, 4, 0, 0, 0, 0, 0]))
        >>> sorted(metric.compute().keys())
        ['mean', 'std']
    """

    full_state_update = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float]]] = None,
        raw: bool = False,
        sampling_strategy: str = "multinomial",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of tpumetrics_torch.Metric but received {base_metric}"
            )
        super().__init__(**{"device": base_metric.device, **kwargs})
        self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but received {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self._rng = np.random.default_rng(seed)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample every tensor input along dim 0, once per copy."""
        sizes = [len(a) for a in (*args, *kwargs.values()) if isinstance(a, Tensor)]
        if not sizes:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        for idx in range(self.num_bootstraps):
            sample_idx = _bootstrap_sampler(sizes[0], self.sampling_strategy, self._rng)
            if sample_idx.size == 0:
                continue
            sample = torch.as_tensor(sample_idx, device=self.device)

            def _select(x: Any) -> Any:
                return x.index_select(0, sample) if isinstance(x, Tensor) else x

            self.metrics[idx].update(*(_select(a) for a in args), **{k: _select(v) for k, v in kwargs.items()})

    def compute(self) -> Dict[str, Tensor]:
        """The mean, std (ddof 1), quantiles and raw values over the copies."""
        computed_vals = torch.stack([m.compute() for m in self.metrics], dim=0)
        output_dict: Dict[str, Tensor] = {}
        if self.mean:
            output_dict["mean"] = computed_vals.mean(dim=0)
        if self.std:
            output_dict["std"] = computed_vals.std(dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=computed_vals.dtype, device=computed_vals.device)
            output_dict["quantile"] = torch.quantile(computed_vals, q, dim=0)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Update with resampling and return the current statistics."""
        self.update(*args, **kwargs)
        return self.compute()

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()
