"""Shared text-metric helpers (port of ``tpumetrics/functional/text/helper.py``).

String processing is host Python by its semantics: strings do not cross to a
device. Only the count statistics that come out of it live on the device, as
sum or cat states. A functional text function has no input tensor to take a
device from, so it takes ``device=``: the current card when omitted (raising
without one, ``metric._resolve_device``), ``"cpu"`` to run on the host.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np


def _token_ids(*token_sequences: Sequence) -> list:
    """Map tokens to dense collision-free integer ids (one vocabulary across
    the given sequences), so that the dynamic programs compare numpy ids."""
    vocab: dict = {}
    out = []
    for seq in token_sequences:
        out.append(np.asarray([vocab.setdefault(t, len(vocab)) for t in seq], dtype=np.int64))
    return out


def _edit_distance(prediction_tokens: Sequence, reference_tokens: Sequence, substitution_cost: int = 1) -> int:
    """Levenshtein distance between two token sequences; deletions and
    substitutions go row by row in numpy, insertions by a scan."""
    m, n = len(prediction_tokens), len(reference_tokens)
    if m == 0:
        return n
    if n == 0:
        return m
    pred_ids, ref_ids = _token_ids(prediction_tokens, reference_tokens)
    prev = np.arange(n + 1)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (ref_ids != pred_ids[i - 1]) * substitution_cost
        np.minimum(sub, prev[1:] + 1, out=sub)
        running = cur[0]
        for j in range(1, n + 1):
            running = min(sub[j - 1], running + 1)
            cur[j] = running
        prev = cur
    return int(prev[-1])


def _normalize_inputs(preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> tuple:
    """Promote single strings to lists and check that they pair up."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    preds, target = list(preds), list(target)
    if len(preds) != len(target):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds)} and {len(target)}"
        )
    return preds, target


def _validate_all_str(name: str, values: Sequence) -> None:
    if not all(isinstance(x, str) for x in values):
        raise ValueError(f"Expected all values in argument `{name}` to be string type, but got {values}")
