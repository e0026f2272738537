"""Every query of a retrieval metric at once (port of
``tpumetrics/functional/retrieval/_grouped.py``).

1. Two stable sorts put each query's documents in ranked order,
   contiguously: by the negated score, then by the query id. The score key
   is made canonical first (``0.0`` for both zeros, one NaN), so that the
   card's radix sort, which orders keys by their bits, ties ``-0.0`` with
   ``0.0`` and every NaN with every other, as the CPU's sort and the JAX
   package's ``lexsort`` do.
2. Each query's first and last positions come from ``searchsorted`` over
   the sorted ids; ranks are positions less the query's first position.
3. Per-query sums of float values are differences, at the segment ends, of
   a float64 cumulative sum taken in fixed blocks (:func:`_cumsum64`), cast
   to float32 once: no float atomics, and the same bits in every call on
   the card. The first relevant rank is an integer ``scatter_reduce``
   ("amin").
4. The empty-target policy is a where-mask over per-query validity.

Nothing reads the host but ``empty_target_action="error"``'s check.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tpumetrics_torch.utils.checks import _is_capturing

Tensor = torch.Tensor

# rows of one block of the float64 cumulative sum; torch scans each row of a
# 2-D tensor in a fixed order on the card, where a 1-D scan may not
_SCAN_BLOCK = 1024


class SortedQueries(NamedTuple):
    """Documents of all queries, ranked per query, plus per-query stats."""

    idx: Tensor  # (N,) int32 sorted query ids; invalid rows hold num_queries
    preds: Tensor  # (N,) float32, descending within each query
    target: Tensor  # (N,) float32 relevance
    rank: Tensor  # (N,) int32 0-based rank within its query
    cum_target: Tensor  # (N,) within-query cumulative relevance (inclusive)
    counts: Tensor  # (Q,) int32 docs per query
    pos: Tensor  # (Q,) float32 total relevance per query
    num_queries: int
    starts: Tensor  # (Q,) int64 first position of each query
    ends: Tensor  # (Q,) int64 one past its last position


def _cumsum64(x: Tensor) -> Tensor:
    """Inclusive float64 cumulative sum of a 1-D tensor, with the same bits
    in every call: block sums, then the blocks' offsets, each a scan over the
    rows of a 2-D tensor (a 1-D scan on the card takes whichever partial sums
    are ready first)."""
    x = x.to(torch.float64)
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        return torch.stack([x, torch.zeros_like(x)]).cumsum(1)[0]
    nb = -(-n // _SCAN_BLOCK)
    blocks = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n)).view(nb, _SCAN_BLOCK).cumsum(1)
    totals = blocks[:, -1]
    offsets = _cumsum64(totals) - totals
    return (blocks + offsets[:, None]).reshape(-1)[:n]


def _prefix64(x: Tensor) -> Tensor:
    """``(N + 1,)`` float64: entry ``i`` is the sum of ``x[:i]``."""
    return torch.cat([x.new_zeros((1,), dtype=torch.float64), _cumsum64(x)])


def _canonical_desc_key(preds: Tensor) -> Tensor:
    """The ascending sort key of a descending ranking: ``-preds`` with one
    zero and one NaN."""
    key = -preds
    key = torch.where(key == 0, torch.zeros_like(key), key)
    return torch.where(torch.isnan(key), torch.full_like(key, float("nan")), key)


def _ranked_order(idx: Tensor, preds: Tensor) -> Tensor:
    """The permutation of ``lexsort((-preds, idx))``: by query id, then by
    descending score, ties in input order."""
    by_score = torch.sort(_canonical_desc_key(preds), stable=True).indices
    by_query = torch.sort(idx[by_score], stable=True).indices
    return by_score[by_query]


def sort_queries(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    num_queries: int,
    mask: Optional[Tensor] = None,
) -> SortedQueries:
    """Rank all queries' documents: two stable sorts and the segment bookkeeping."""
    idx = indexes.to(torch.int32)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    invalid = (idx < 0) | (idx >= num_queries)
    if mask is not None:
        invalid = invalid | ~mask
    idx = torch.where(invalid, torch.full_like(idx, num_queries), idx)

    order = _ranked_order(idx, preds)
    idx_s = idx[order]
    preds_s = preds[order]
    target_s = target[order]

    n = idx_s.shape[0]
    queries = torch.arange(num_queries, dtype=torch.int32, device=idx.device)
    starts = torch.searchsorted(idx_s, queries)
    ends = torch.searchsorted(idx_s, queries, right=True)
    counts = (ends - starts).to(torch.int32)
    own = idx_s.clamp(0, num_queries - 1).long()
    rank = (torch.arange(n, device=idx.device) - starts[own]).to(torch.int32)

    prefix = _prefix64(target_s)
    cum_target = (prefix[1:] - prefix[starts][own]).to(torch.float32)
    pos = (prefix[ends] - prefix[starts]).to(torch.float32)
    return SortedQueries(idx_s, preds_s, target_s, rank, cum_target, counts, pos, num_queries, starts, ends)


def _segment_sum(values: Tensor, sq: SortedQueries) -> Tensor:
    """float32 per-query sums of ``values`` (in ranked order): float64
    differences of the prefix sums at the segment ends, cast once."""
    prefix = _prefix64(values)
    return (prefix[sq.ends] - prefix[sq.starts]).to(torch.float32)


def reduce_queries(
    values: Tensor,
    computable: Tensor,
    observed: Tensor,
    empty_target_action: str,
    requirement: str = "positive",
) -> Tensor:
    """Mean over queries with the empty-target policy as where-masks.

    ``computable`` marks queries with the required target present;
    ``observed`` marks queries with any documents at all (index gaps between
    0 and num_queries-1 never contribute).
    """
    if empty_target_action == "error":
        bad = observed & ~computable
        if _is_capturing():
            raise NotImplementedError(
                "empty_target_action='error' is a data-dependent host check and cannot run in a CUDA graph capture;"
                " use 'skip'/'neg'/'pos' there."
            )
        if bool(bad.any()):
            raise ValueError(f"`compute` method was provided with a query with no {requirement} target.")

    if empty_target_action == "skip":
        used = observed & computable
        filler = torch.zeros_like(values)
    elif empty_target_action == "pos":
        used = observed
        filler = torch.ones_like(values)
    else:  # "neg" (and "error" after the check above)
        used = observed
        filler = torch.zeros_like(values)

    values = torch.where(computable, values, filler)
    total = torch.where(used, values, torch.zeros_like(values)).sum()
    denom = used.sum()
    return torch.where(denom > 0, total / denom.clamp(min=1), torch.zeros_like(total))


def _topk_mask(sq: SortedQueries, top_k: Optional[int]) -> Tensor:
    if top_k is None:
        return torch.ones_like(sq.rank, dtype=torch.bool)
    return sq.rank < top_k


def grouped_precision(
    sq: SortedQueries, top_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor]:
    """precision@k per query."""
    counts = sq.counts.to(torch.float32)
    k = torch.as_tensor(float(top_k), device=counts.device) if top_k is not None else counts.max()
    denom = torch.minimum(k, counts) if (adaptive_k or top_k is None) else k
    rel = _segment_sum(sq.target * _topk_mask(sq, top_k), sq)
    values = rel / torch.clamp(denom, min=1.0)
    return values, sq.pos > 0


def grouped_recall(sq: SortedQueries, top_k: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """recall@k per query."""
    rel = _segment_sum(sq.target * _topk_mask(sq, top_k), sq)
    values = rel / torch.clamp(sq.pos, min=1.0)
    return values, sq.pos > 0


def grouped_fall_out(sq: SortedQueries, top_k: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """fall-out@k per query: retrieved non-relevant / all non-relevant."""
    neg_target = 1.0 - sq.target
    neg_total = _segment_sum(neg_target, sq)
    neg_rel = _segment_sum(neg_target * _topk_mask(sq, top_k), sq)
    values = neg_rel / torch.clamp(neg_total, min=1.0)
    return values, neg_total > 0


def grouped_hit_rate(sq: SortedQueries, top_k: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """hit-rate@k per query."""
    rel = _segment_sum(sq.target * _topk_mask(sq, top_k), sq)
    return (rel > 0).to(torch.float32), sq.pos > 0


def grouped_r_precision(sq: SortedQueries) -> Tuple[Tensor, Tensor]:
    """R-precision per query: precision at R = number of relevant docs."""
    r_of_doc = sq.pos[sq.idx.clamp(0, sq.num_queries - 1).long()]
    rel = _segment_sum(sq.target * (sq.rank < r_of_doc), sq)
    values = rel / torch.clamp(sq.pos, min=1.0)
    return values, sq.pos > 0


def grouped_reciprocal_rank(sq: SortedQueries, top_k: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """MRR per query: 1 / rank of the first relevant document."""
    n = sq.rank.shape[0]
    ranks = torch.where(sq.target > 0, sq.rank, torch.full_like(sq.rank, n))
    first = torch.full((sq.num_queries + 1,), n, dtype=torch.int32, device=ranks.device)
    first = first.scatter_reduce(0, sq.idx.long(), ranks, reduce="amin")[: sq.num_queries]
    in_k = first < (top_k if top_k is not None else n)
    values = torch.where(in_k, 1.0 / torch.clamp(first + 1.0, min=1.0), torch.zeros((), device=first.device))
    return values, sq.pos > 0


def grouped_average_precision(sq: SortedQueries, top_k: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """MAP per query: mean over relevant docs in the top-k of
    (relevant seen so far) / (rank + 1)."""
    hits = sq.target * _topk_mask(sq, top_k)
    precision_at = sq.cum_target / (sq.rank + 1.0)
    ap_sum = _segment_sum(hits * precision_at, sq)
    rel_in_k = _segment_sum(hits, sq)
    values = ap_sum / torch.clamp(rel_in_k, min=1.0)
    return values, sq.pos > 0


def _discount(rank: Tensor, k: int) -> Tensor:
    return torch.where(rank < k, 1.0 / torch.log2(rank.to(torch.float32) + 2.0), torch.zeros((), device=rank.device))


def grouped_ndcg(
    sq_by_pred: SortedQueries, sq_by_target: SortedQueries, top_k: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """Tie-averaged nDCG per query (sklearn's ``_tie_averaged_dcg``).

    Each document contributes (mean target of its tie group) * (its rank
    discount), which sums to the per-group formulation. Tie groups are runs
    of equal (query, score) pairs, adjacent after the sort; a run's bounds
    are found by ``searchsorted`` over the run ids, and its target sum is a
    difference of the float64 prefix sums.
    """
    n = sq_by_pred.rank.shape[0]
    k = top_k if top_k is not None else n
    idx, preds = sq_by_pred.idx, sq_by_pred.preds
    same_as_prev = torch.cat(
        [torch.zeros((1,), dtype=torch.bool, device=idx.device), (idx[1:] == idx[:-1]) & (preds[1:] == preds[:-1])]
    )
    tie_id = torch.cumsum((~same_as_prev).to(torch.int32), 0, dtype=torch.int32) - 1
    lo = torch.searchsorted(tie_id, tie_id)
    hi = torch.searchsorted(tie_id, tie_id, right=True)
    prefix = _prefix64(sq_by_pred.target)
    tie_t_sum = (prefix[hi] - prefix[lo]).to(torch.float32)
    avg_t = tie_t_sum / (hi - lo).to(torch.float32)
    dcg = _segment_sum(avg_t * _discount(sq_by_pred.rank, k), sq_by_pred)
    idcg = _segment_sum(sq_by_target.target * _discount(sq_by_target.rank, k), sq_by_target)
    values = torch.where(idcg > 0, dcg / torch.where(idcg > 0, idcg, torch.ones_like(idcg)), torch.zeros_like(dcg))
    return values, sq_by_pred.pos > 0


def grouped_precision_recall_curve(
    sq: SortedQueries, max_k: int, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """(Q, max_k) precision and recall at every k per query.

    The grid of ranked relevances is a gather: cell ``(q, r)`` reads the row
    at position ``starts[q] + r`` when ``r < counts[q]``, else 0, so each
    kept (query, rank) cell gets exactly one row, the rows past ``max_k``
    are never read, and nothing is scattered. A cumulative sum along k
    follows; queries shorter than max_k plateau.
    """
    n = sq.target.shape[0]
    ranks = torch.arange(max_k, device=sq.target.device)
    kept = ranks[None, :] < sq.counts[:, None]
    rows = torch.clamp(sq.starts[:, None] + ranks[None, :], max=max(n - 1, 0))
    if n == 0:
        grid = torch.zeros(kept.shape, dtype=torch.float32, device=kept.device)
    else:
        grid = torch.where(kept, sq.target[rows], torch.zeros((), device=kept.device))
    rel_cum = torch.cumsum(grid, dim=1)

    topk = torch.arange(1, max_k + 1, dtype=torch.float32, device=grid.device)[None, :]
    if adaptive_k:
        denom = torch.minimum(topk, torch.clamp(sq.counts[:, None].to(torch.float32), min=1.0))
    else:
        denom = topk
    precision = rel_cum / denom
    recall = rel_cum / torch.clamp(sq.pos[:, None], min=1.0)
    return precision, recall, sq.pos > 0
