#!/usr/bin/env python3
"""Time the CUDA ``bert_greedy_match`` kernel of one tree of the port on one card.

Two versions of the kernel are compared by running this script once for
each tree, in turns, in one run on one card; for a parent and a change::

    python3 scripts/time_bert_match.py --tree _archive/parent --label parent
    python3 scripts/time_bert_match.py --label change

``--tree`` is a checkout whose ``tpumetrics_torch`` is imported and built
(default: the checkout that holds this script). The shapes timed are the
ones ``chip_smoke.py``'s ``bert_kernel_phase`` times: the MT stream's call
(WMT14 newstest2014's 3,003 pairs at their token counts, L = 1, D = 1,024)
and ``all_layers`` (64 x 25 x 512 x 512 x 1,024), on this checkout's
``chip_smoke.bert_match_inputs`` from the seed. Whatever the tree, the
timing is this checkout's ``chip_smoke.cuda_ms`` (the median of ``--reps``
calls between CUDA events, the L2 flushed before each) and the contract is
this checkout's ``chip_smoke.bert_match_check`` (two calls bit for bit,
each cell within 2x the plain version's error of float64 + 1e-6). Beside
the kernel it times the composite torch ops (``einsum``, two ``amax``, two
weighted sums in one pass, TF32 off). One JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="checkout whose tpumetrics_torch is timed")
    parser.add_argument("--label", default="change")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this checkout's inputs, timing and contract, whatever the tree

    sys.path.insert(0, str(Path(args.tree).resolve()))
    import tpumetrics_torch
    from tpumetrics_torch.ops import bert_match as bm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    preds, target = cs.mt_pairs()
    tok = cs.roberta_tokenizer()
    sp, st = tok(preds)["input_ids"].shape[1], tok(target)["input_ids"].shape[1]
    shapes = {"mt": (len(preds), 1, sp, st, 1024), "all_layers": cs.BERT_ALL_LAYERS}
    flush = cs.l2_flush(torch)
    out = {"label": args.label, "package": str(Path(tpumetrics_torch.__file__).parent), "card": smi}
    for i, (label, shape) in enumerate(shapes.items()):
        inputs = cs.bert_match_inputs(torch, *shape, seed=cs.SEED + 40 + i)
        held = cs.bert_match_check(torch, bm, label, inputs)
        ms, host_ms = cs.cuda_ms(torch, lambda: bm.bert_greedy_match(*inputs), args.reps, flush)
        composite_ms, _ = cs.cuda_ms(torch, lambda: bm._match(*inputs, shape[0]), 3, flush)
        bound = cs.bert_match_bound(*shape)
        out[label] = {"shape": list(shape), "tile": bm.tile(shape[2], shape[3]) if hasattr(bm, "tile") else 64,
                      "ms": ms, "host_ms": host_ms, "composite_ms": composite_ms, "bound_ms": bound["bound_ms"],
                      "bound_by": bound["bound_by"], "ratio": ms / bound["bound_ms"], "excess": held["excess"],
                      "err": held["err"], "err_plain": held["err_plain"]}
        del inputs
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
