"""Panoptic quality shared machinery (port of
``tpumetrics/functional/detection/_panoptic_quality_common.py``).

A segment ("color") is a ``(category_id, instance_id)`` pair. The JAX
package matches segments on the host, one ``np.unique`` per image; here the
whole batch is matched on the metric's device at once: ``torch.unique``
over int64 color keys (category in the high 32 bits, instance in the low
32), made sample-local by a second key that puts the sample index above the
color's dense id, gives every segment's area, and one more ``torch.unique``
over (prediction segment, target segment) pixel pairs gives every
intersection. The sizes of those uniques are read on the host, so an update
waits for the card (the metrics mark ``_update_reads_host``).

The IoUs are summed per category in float64 by a masked reduction (never a
float ``index_add_``, whose atomics would sum in a changing order) and cast
to float32 once per batch, as the JAX package casts its float64 numpy sums;
the counts are exact integer ``bincount``s.
"""

from __future__ import annotations

from typing import Collection, Dict, Optional, Set, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    """Validate and normalize the category sets (reference :65-93)."""
    things_parsed = set(things)
    stuffs_parsed = set(stuffs)
    if not all(isinstance(t, (int, np.integer)) for t in things_parsed):
        raise TypeError(f"Expected argument `things` to contain `int` categories, but got {things}")
    if not all(isinstance(s, (int, np.integer)) for s in stuffs_parsed):
        raise TypeError(f"Expected argument `stuffs` to contain `int` categories, but got {stuffs}")
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}"
        )
    if not (things_parsed | stuffs_parsed):
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    return things_parsed, stuffs_parsed


def _validate_inputs(preds: Tensor, target: Tensor) -> None:
    """Shape validation (reference :96-121)."""
    if preds.shape != target.shape:
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same shape, got {tuple(preds.shape)} and"
            f" {tuple(target.shape)}"
        )
    if preds.ndim < 3:
        raise ValueError(
            "Expected argument `preds` to have at least one spatial dimension (B, *spatial_dims, 2),"
            f" got {tuple(preds.shape)}"
        )
    if preds.shape[-1] != 2:
        raise ValueError(
            f"Expected argument `preds` to have exactly 2 channels in the last dimension, got {tuple(preds.shape)}"
        )


def _get_void_color(things: Set[int], stuffs: Set[int]) -> Tuple[int, int]:
    """A color guaranteed unused (reference :124-136)."""
    unused_category_id = 1 + max([0, *list(things), *list(stuffs)])
    return unused_category_id, 0


def _get_category_id_to_continuous_id(things: Set[int], stuffs: Set[int]) -> Dict[int, int]:
    """Map category ids to 0..K-1, things first (reference :139-157)."""
    cat_id_to_continuous_id = {thing_id: idx for idx, thing_id in enumerate(sorted(things))}
    cat_id_to_continuous_id.update({stuff_id: idx + len(things) for idx, stuff_id in enumerate(sorted(stuffs))})
    return cat_id_to_continuous_id


def _as_long(x, device: Optional[torch.device] = None) -> Tensor:
    if isinstance(x, Tensor):
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)


def _prepocess_inputs(
    things: Set[int],
    stuffs: Set[int],
    inputs: Tensor,
    void_color: Tuple[int, int],
    allow_unknown_category: bool,
) -> Tensor:
    """Flatten spatial dims, zero stuff instance ids, map unknown categories
    to void (reference :175-211). Returns a ``(B, P, 2)`` int64 tensor on the
    input's device."""
    out = _as_long(inputs)
    out = out.reshape(out.shape[0], -1, 2)
    cats = out[..., 0]
    dev = out.device
    mask_stuffs = torch.isin(cats, torch.tensor(sorted(stuffs), dtype=torch.int64, device=dev))
    mask_things = torch.isin(cats, torch.tensor(sorted(things), dtype=torch.int64, device=dev))
    inst = torch.where(mask_stuffs, torch.zeros_like(out[..., 1]), out[..., 1])
    known = mask_things | mask_stuffs
    if not allow_unknown_category and not bool(known.all()):
        raise ValueError(f"Unknown categories found: {torch.unique(cats[~known]).cpu().numpy()}")
    cats = torch.where(known, cats, torch.full_like(cats, void_color[0]))
    inst = torch.where(known, inst, torch.full_like(inst, void_color[1]))
    return torch.stack([cats, inst], dim=-1)


def _panoptic_quality_update(
    flatten_preds: Tensor,
    flatten_target: Tensor,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    modified_metric_stuffs: Optional[Set[int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Match the segments of every sample of a batch with IoU > 0.5 and
    return the batch's per-category ``(iou_sum, true_positives,
    false_positives, false_negatives)`` as float32 (reference :312-444).

    Samples are matched independently. For the modified PQ variant, stuff
    categories accumulate IoU at threshold 0 and ``true_positives`` counts
    their target segments instead.
    """
    stuffs_mod = sorted(modified_metric_stuffs or ())
    dev = flatten_preds.device
    num_categories = len(cat_id_to_continuous_id)
    b, p = flatten_preds.shape[0], flatten_preds.shape[1]

    def encode(x: Tensor) -> Tensor:
        return (x[..., 0] << 32) | (x[..., 1] & 0xFFFFFFFF)

    void_key = (int(void_color[0]) << 32) | int(void_color[1])
    # colors -> dense ids shared by both sides, then sample-local segment ids
    colors, inv = torch.unique(torch.cat([encode(flatten_preds).reshape(-1), encode(flatten_target).reshape(-1)]),
                               return_inverse=True)
    n_colors = colors.numel()
    sample = torch.arange(b, device=dev)[:, None] * n_colors
    pred_seg, pred_inv, pred_area = torch.unique(
        (sample + inv[: b * p].reshape(b, p)).reshape(-1), return_inverse=True, return_counts=True
    )
    tgt_seg, tgt_inv, tgt_area = torch.unique(
        (sample + inv[b * p:].reshape(b, p)).reshape(-1), return_inverse=True, return_counts=True
    )
    n_tgt = tgt_seg.numel()
    pairs, inter = torch.unique(pred_inv * n_tgt + tgt_inv, return_counts=True)
    pi, ti = pairs // n_tgt, pairs % n_tgt
    pred_key, tgt_key = colors[pred_seg % n_colors], colors[tgt_seg % n_colors]
    pred_void, tgt_void = pred_key == void_key, tgt_key == void_key
    pred_cat, tgt_cat = pred_key >> 32, tgt_key >> 32

    # each segment's pixels that fall on the other side's void (pairs are unique, so the writes are)
    pred_void_area = torch.zeros_like(pred_area)
    on_void = tgt_void[ti]
    pred_void_area[pi[on_void]] = inter[on_void]
    void_tgt_area = torch.zeros_like(tgt_area)
    from_void = pred_void[pi]
    void_tgt_area[ti[from_void]] = inter[from_void]

    cat_ids = torch.tensor(sorted(cat_id_to_continuous_id), dtype=torch.int64, device=dev)
    cont_of = torch.tensor(
        [cat_id_to_continuous_id[c] for c in sorted(cat_id_to_continuous_id)], dtype=torch.int64, device=dev
    )

    def continuous(cat: Tensor) -> Tensor:
        return cont_of[torch.searchsorted(cat_ids, cat).clamp(max=cat_ids.numel() - 1)]

    stuff_ids = torch.tensor(stuffs_mod, dtype=torch.int64, device=dev)
    pred_mod, tgt_mod = torch.isin(pred_cat, stuff_ids), torch.isin(tgt_cat, stuff_ids)

    same = ~tgt_void[ti] & ~pred_void[pi] & (pred_cat[pi] == tgt_cat[ti])
    union = pred_area[pi] - pred_void_area[pi] + tgt_area[ti] - void_tgt_area[ti] - inter
    iou = inter.to(torch.float64) / torch.where(same, union, torch.ones_like(union)).to(torch.float64)
    pair_mod = tgt_mod[ti]
    matched = same & ~pair_mod & (iou > 0.5)
    summed = matched | (same & pair_mod & (iou > 0))
    pair_cont = continuous(tgt_cat[ti])
    onehot = pair_cont[None, :] == torch.arange(num_categories, device=dev)[:, None]
    iou_sum = torch.where(onehot & summed[None, :], iou[None, :], torch.zeros((), dtype=torch.float64, device=dev))
    iou_sum = iou_sum.sum(dim=1)

    def count(mask: Tensor, cat: Tensor) -> Tensor:
        return torch.bincount(continuous(cat[mask]), minlength=num_categories)

    true_positives = count(matched, tgt_cat[ti])
    pred_matched = torch.zeros_like(pred_void)
    pred_matched[pi[matched]] = True
    tgt_matched = torch.zeros_like(tgt_void)
    tgt_matched[ti[matched]] = True
    # false negatives: unmatched target segments not mostly void in the preds
    fn_mask = ~tgt_matched & ~tgt_void & ~tgt_mod
    fn_mask &= void_tgt_area.to(torch.float64) / tgt_area.to(torch.float64) <= 0.5
    false_negatives = count(fn_mask, tgt_cat)
    # false positives: unmatched predicted segments not mostly void in the target
    fp_mask = ~pred_matched & ~pred_void & ~pred_mod
    fp_mask &= pred_void_area.to(torch.float64) / pred_area.to(torch.float64) <= 0.5
    false_positives = count(fp_mask, pred_cat)
    # modified variant: a stuff category's "TP" counts its target segments
    true_positives = true_positives + count(tgt_mod, tgt_cat)

    return (
        iou_sum.to(torch.float32),
        true_positives.to(torch.float32),
        false_positives.to(torch.float32),
        false_negatives.to(torch.float32),
    )


def _panoptic_quality_compute(
    iou_sum: Tensor, true_positives: Tensor, false_positives: Tensor, false_negatives: Tensor
) -> Tensor:
    """PQ = mean over categories of IoU / (TP + FP/2 + FN/2) (reference :447-469)."""
    denominator = true_positives + 0.5 * false_positives + 0.5 * false_negatives
    valid = denominator > 0
    per_class = iou_sum / torch.where(valid, denominator, torch.ones_like(denominator))
    n_valid = valid.sum()
    total = torch.where(valid, per_class, torch.zeros_like(per_class)).sum()
    return torch.where(n_valid > 0, total / n_valid.clamp(min=1), torch.zeros_like(total))
