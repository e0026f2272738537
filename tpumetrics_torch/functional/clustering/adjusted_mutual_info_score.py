"""Adjusted mutual information (port of
``tpumetrics/functional/clustering/adjusted_mutual_info_score.py``).

The expected mutual information of two random clusterings with the same
marginals is the hypergeometric sum over the ``(rows, cols, n_ij)`` grid,
taken in float64 on the tensors' device with ``torch.lgamma`` (the JAX
package's eager value: a host float64 grid through scipy's ``gammaln``),
in chunks of n_ij values, and of rows where one n_ij already fills the
budget, so one chunk's float64 temporaries stay within 1 GiB. There is no
float32 variant: the lgamma differences lose some three digits there.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from tpumetrics_torch.functional.clustering.mutual_info_score import (
    _mutual_info_score_compute,
    _mutual_info_score_update,
)
from tpumetrics_torch.functional.clustering.normalized_mutual_info_score import _entropy_normalizer
from tpumetrics_torch.functional.clustering.utils import _validate_average_method_arg

Tensor = torch.Tensor

_EMI_BUDGET = 1 << 23  # float64 elements of one grid chunk (64 MiB); its dozen temporaries stay within 1 GiB


def adjusted_mutual_info_score(
    preds: Tensor,
    target: Tensor,
    average_method: str = "arithmetic",
    num_classes_preds: Optional[int] = None,
    num_classes_target: Optional[int] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """AMI = (MI - E[MI]) / (generalized-mean(H(preds), H(target)) - E[MI]).

    Example:
        >>> import torch
        >>> from tpumetrics_torch.functional.clustering import adjusted_mutual_info_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> round(float(adjusted_mutual_info_score(preds, target, "arithmetic")), 2)
        -0.25
    """
    _validate_average_method_arg(average_method)
    contingency = _mutual_info_score_update(preds, target, num_classes_preds, num_classes_target, mask)
    mutual_info = _mutual_info_score_compute(contingency)
    expected_mutual_info = expected_mutual_info_score(contingency, torch.sum(contingency))
    normalizer = _entropy_normalizer(preds, target, average_method, num_classes_preds, num_classes_target, mask)
    denominator = normalizer - expected_mutual_info
    eps = torch.finfo(torch.float32).eps
    # sign-preserving clamp away from 0
    denominator = torch.where(
        denominator < 0, torch.clamp(denominator, max=-eps), torch.clamp(denominator, min=eps)
    )
    return (mutual_info - expected_mutual_info) / denominator


def expected_mutual_info_score(contingency: Tensor, n_samples: Any, nij_bound: Optional[int] = None) -> Tensor:
    """float32 expected MI of two random clusterings with the marginals of
    ``contingency``, summed in float64 on its device.

    Reads two numbers on the host, as the JAX package's eager path does: the
    sample count and the largest marginal (the n_ij grid's extent).
    ``nij_bound`` (the JAX package's static grid size under jit) is accepted
    and unused.
    """
    del nij_bound
    c = contingency.to(torch.float64)
    a = c.sum(dim=1)  # (R,) target marginals
    b = c.sum(dim=0)  # (C,) preds marginals
    if a.shape[0] == 1 or b.shape[0] == 1:
        return torch.zeros((), dtype=torch.float32, device=contingency.device)
    n = torch.full((), float(n_samples), dtype=torch.float64, device=c.device)
    m = int(torch.maximum(a.max(), b.max())) + 1
    rows, cols = a.shape[0], b.shape[0]
    nij_chunk = max(1, min(m, _EMI_BUDGET // (rows * cols)))
    row_chunk = rows if rows * cols * nij_chunk <= _EMI_BUDGET else max(1, _EMI_BUDGET // (cols * nij_chunk))
    total = torch.zeros((), dtype=torch.float64, device=c.device)
    for lo in range(0, m, nij_chunk):
        for r0 in range(0, rows, row_chunk):
            total = total + _expected_mutual_info_grid(a[r0 : r0 + row_chunk], b, n, lo, min(lo + nij_chunk, m))
    return total.to(torch.float32)


def _expected_mutual_info_grid(a: Tensor, b: Tensor, n_t: Tensor, nij_lo: int, nij_hi: int) -> Tensor:
    """The float64 EMI sum over the masked ``(len(a), len(b), n_ij)`` grid of
    the window ``[nij_lo, nij_hi)``, term for term the JAX package's grid;
    ``n_t`` is the float64 sample count."""
    nijs = torch.arange(nij_lo, nij_hi, dtype=torch.float64, device=a.device)
    safe_nijs = torch.where(nijs == 0, 1.0, nijs)  # n_ij = 0 only matters masked out

    start = torch.clamp(a[:, None] + b[None, :] - n_t, min=1.0)
    end = torch.minimum(a[:, None], b[None, :]) + 1
    mask = (nijs[None, None, :] >= start[:, :, None]) & (nijs[None, None, :] < end[:, :, None])

    safe_a = torch.where(a > 0, a, 1.0)
    safe_b = torch.where(b > 0, b, 1.0)
    term1 = nijs / n_t
    log_nnij = torch.log(n_t) + torch.log(safe_nijs)
    term2 = log_nnij[None, None, :] - torch.log(safe_a)[:, None, None] - torch.log(safe_b)[None, :, None]

    gln_a = torch.lgamma(safe_a + 1)
    gln_b = torch.lgamma(safe_b + 1)
    gln_na = torch.lgamma(torch.clamp(n_t - a, min=0) + 1)
    gln_nb = torch.lgamma(torch.clamp(n_t - b, min=0) + 1)
    gln_nnij = torch.lgamma(nijs + 1) + torch.lgamma(n_t + 1)

    # lgamma's poles at non-positive arguments lie off the mask only
    arg_an = torch.where(mask, a[:, None, None] - nijs[None, None, :] + 1, 1.0)
    arg_bn = torch.where(mask, b[None, :, None] - nijs[None, None, :] + 1, 1.0)
    arg_nabn = torch.where(mask, n_t - a[:, None, None] - b[None, :, None] + nijs[None, None, :] + 1, 1.0)

    gln = (
        (gln_a[:, None] + gln_b[None, :] + gln_na[:, None] + gln_nb[None, :])[:, :, None]
        - gln_nnij[None, None, :]
        - torch.lgamma(arg_an)
        - torch.lgamma(arg_bn)
        - torch.lgamma(arg_nabn)
    )
    terms = term1[None, None, :] * term2 * torch.exp(gln)
    return torch.sum(torch.where(mask, terms, 0.0))
