#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpumetrics_torch``) on one CUDA card.

Run from the repository root, on a machine with an NVIDIA card and ``nvcc``::

    python3 chip_smoke.py

Phases, each of which passes or exits non-zero:

1. the card's name and power limit;
2. build every CUDA kernel of the port from ``tpumetrics_torch/csrc``;
3. kernel phase: ``binned_confusion`` against its plain torch version on
   the same inputs, exact, at the main path's shapes and at edge cases
   (contended narrow C, T=1, unsorted and duplicate thresholds with +-inf,
   NaN, -0.0 and 0.0, more thresholds than shared memory holds, C=8193),
   with the kernel's time (on the device, between CUDA events, the L2
   flushed before each call) and the host's time to make the call, the
   plain version's time, the time of the torch-ops histogram path as a
   yardstick, and the bound;
4. slice phase: an ImageNet-1k validation-sized evaluation (50,000 samples,
   1000 classes, batches of 8192 and a ragged 848) through
   ``MetricCollection({acc, f1, auroc(T=200)})`` on the card, held against
   the same stream on the CPU (identical int32 states, values within 1e-6)
   and against numpy counts; the kernel's launches in that run are counted.
   The bench headline shape (N=8192, C=128, T=64, 5 batches) runs the same
   way.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the port's
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int, ahead) -> tuple:
    """Median milliseconds of ``fn()`` over ``reps`` calls after 3 warm ones,
    each between its own pair of CUDA events, and the median host time of the
    call itself (from the call to its return; nothing is synchronised).
    ``ahead()`` runs before each call, outside the events: device work that
    evicts the L2 and outlasts the host's time to queue ``fn()``, so the
    device reaches the first event with the call already queued. The time
    between the events is then the device's: the host's launch cost is left
    out of it, and is the second number."""
    for _ in range(3):
        fn()
    times, host = [], []
    for _ in range(reps):
        ahead()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(np.median(host))


def l2_flush(torch):
    """``ahead`` for ``cuda_ms``: one pass over 512 MB (ten times the L2), about
    0.37 ms of device time on an H100, in a kernel (``bitwise_not``) that no wrapper timed
    here launches, so a trace can leave it out by name."""
    buf = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    return lambda: buf.bitwise_not_()


def binned_bound(n: int, c: int, t: int) -> dict:
    """Least time for ``binned_confusion`` on an H100 SXM: the inputs read once
    (preds, y, v as float32, the thresholds) and the two int32 outputs written
    once, over the memory rate; against the operations the function needs, at
    the fp32 rate outside the tensor cores. Those are not this kernel's N*C*T
    comparisons: with the thresholds sorted once, each pred finds its bucket in
    ceil(log2(T + 1)) comparisons and adds its y and v bits there (2 adds), and
    a suffix sum over the T buckets of each class (2*T*C adds) gives the
    counts."""
    nbytes = 3 * n * c * 4 + t * 4 + 2 * t * c * 4
    ops = n * c * (math.ceil(math.log2(t + 1)) + 2) + 2 * t * c
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_OPS_PER_S * 1e3
    return {
        "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def kernel_phase(torch, bc) -> dict:
    """Kernel against plain version, exact, at every listed shape; times at the two large ones."""
    from tpumetrics_torch.functional.classification.precision_recall_curve import _binned_confusion_hist

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def inputs(n, c, t, ties=False, special=False, unsorted=False, edge_thr=False, one_bucket=False):
        preds = rng.random((n, c), dtype=np.float32)
        bits = rng.integers(0, 2, (n, c)).astype(np.float32)
        valid = (rng.random((n, c)) < 0.9).astype(np.float32)
        thr = np.linspace(0, 1, t, dtype=np.float32) if t > 1 else np.asarray([0.5], np.float32)
        if unsorted:
            thr = rng.permutation(np.concatenate([thr, thr[: t // 2]])).astype(np.float32)
        if ties:
            k = min(n, thr.shape[0])
            preds[:k, 0] = thr[:k]
            preds[k : 2 * k, -1] = thr[:k][: max(0, min(k, n - k))]
        if special:
            thr = np.concatenate([thr, np.asarray([-np.inf, np.inf, 0.0, 1.0], np.float32)])
            flat = preds.reshape(-1)
            idx = rng.choice(flat.size, size=min(flat.size, 64), replace=False)
            flat[idx[0::3]] = np.nan
            flat[idx[1::3]] = np.inf
            flat[idx[2::3]] = -np.inf
        if edge_thr:
            odd = [np.nan, np.inf, -np.inf, -0.0, 0.0, 0.5, 0.5, np.nan, -0.0, 1.0]
            thr = rng.permutation(np.concatenate([thr, np.asarray(odd, np.float32)])).astype(np.float32)
            flat = preds.reshape(-1)
            idx = rng.choice(flat.size, size=min(flat.size, 600), replace=False)
            for j, val in enumerate([0.0, -0.0, 0.5, 1.0, np.nan, np.inf]):
                flat[idx[j::6]] = val
        if one_bucket:
            preds[:] = np.float32(0.999)
        return [torch.from_numpy(x).to(dev) for x in (preds, bits * valid, valid, thr)]

    cases = [
        ("headline (bench) 8192x128x64", (8192, 128, 64), {}),
        ("main path 8192x1000x200", (8192, 1000, 200), {}),
        ("ragged last batch 848x1000x200", (848, 1000, 200), {}),
        ("test_ops 257x5x13", (257, 5, 13), {"ties": True}),
        ("test_ops 64x1x3", (64, 1, 3), {"ties": True}),
        ("test_ops 130x4x129", (130, 4, 129), {"ties": True}),
        ("micro path 8192000x1x200", (8192 * 1000, 1, 200), {}),
        ("wider than the TPU kernel 256x8193x64", (256, 8193, 64), {}),
        ("T=1 1000x37x1", (1000, 37, 1), {}),
        ("ties 4096x33x200", (4096, 33, 200), {"ties": True}),
        ("NaN and +-inf preds 2048x130x64", (2048, 130, 64), {"special": True}),
        ("unsorted duplicate thresholds 3000x70x100", (3000, 70, 100), {"unsorted": True}),
        ("contended micro path 1048576x1x200", (1 << 20, 1, 200), {}),
        ("every pred in one bucket 200000x3x200", (200000, 3, 200), {"one_bucket": True}),
        ("+-inf, NaN, -0.0 and 0.0 thresholds 2048x130x64", (2048, 130, 64), {"edge_thr": True}),
        ("bucket ranges 8192x128x4096", (8192, 128, 4096), {}),
        ("histogram beyond shared memory 512x3x30000, unsorted with duplicates", (512, 3, 30000), {"unsorted": True}),
    ]
    max_err = 0.0
    timed = {}
    for label, (n, c, t), kw in cases:
        preds, y, v, thr = inputs(n, c, t, **kw)
        tp, pp = bc.binned_confusion_fused(preds, y, v, thr)
        torch.cuda.synchronize()
        ref_tp, ref_pp = bc.binned_confusion_plain(preds, y, v, thr)
        err = max(float((tp - ref_tp).abs().max()), float((pp - ref_pp).abs().max()))
        max_err = max(max_err, err)
        check(torch.equal(tp, ref_tp) and torch.equal(pp, ref_pp), f"kernel != plain version at {label} (err {err})")
        print(f"kernel phase: {label}: exact (T={thr.shape[0]})", flush=True)
        if label.startswith(("headline", "main path")):
            flush = l2_flush(torch)
            ms, host_ms = cuda_ms(torch, lambda: bc.binned_confusion_counts(preds, y, v, thr), reps=30, ahead=flush)
            plain_ms, _ = cuda_ms(torch, lambda: bc.binned_confusion_plain(preds, y, v, thr), reps=5, ahead=flush)
            # yardstick, not a port: the torch-ops histogram (argsort, searchsorted, bincount, cumsum)
            bits, invalid = y != 0, v == 0
            hist_ms, _ = cuda_ms(torch, lambda: _binned_confusion_hist(preds, bits, thr, invalid), reps=10, ahead=flush)
            bound = binned_bound(n, c, thr.shape[0])
            timed[label] = {
                "n": n, "c": c, "t": thr.shape[0], "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                "torch_ops_hist_ms": hist_ms, **bound,
            }
            print(
                f"kernel phase: {label}: kernel {ms:.4f} ms on the device ({ms / bound['bound_ms']:.2f}x its bound),"
                f" {host_ms:.4f} ms of host time to make the call; plain {plain_ms:.4f} ms,"
                f" torch-ops histogram {hist_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms"
                f" by {bound['bound_by']} (bytes {bound['bytes']} -> {bound['bytes_ms']:.4f} ms at 3.35 TB/s;"
                f" ops {bound['ops']} -> {bound['ops_ms']:.4f} ms at 67 TFLOP/s fp32)",
                flush=True,
            )
            del flush, bits, invalid
        del preds, y, v, thr, tp, pp, ref_tp, ref_pp
        torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "timed": timed}


def make_stream(n: int, c: int, batch: int, seed: int):
    """Probabilities (softmax of seeded logits, the true class boosted) and labels, in batches."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, c, size=n)
    logits = rng.standard_normal((n, c), dtype=np.float32) * 2.0
    logits[np.arange(n), target] += 7.0
    logits -= logits.max(axis=1, keepdims=True)
    probs = np.exp(logits.astype(np.float64))
    probs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    return [(probs[i : i + batch], target[i : i + batch]) for i in range(0, n, batch)]


def numpy_reference(batches, c: int, thresholds: np.ndarray) -> dict:
    """Micro accuracy and the binned per-class tp / predicted-positive counts, in numpy."""
    probs = np.concatenate([b[0] for b in batches])
    target = np.concatenate([b[1] for b in batches])
    n = probs.shape[0]
    t = thresholds.shape[0]
    check(bool(np.all(np.diff(thresholds) > 0)), "numpy reference expects increasing thresholds")
    acc = float(np.mean(np.argmax(probs, axis=1) == target))
    # probs[n, c] >= thr[k]  <=>  k < (number of thresholds <= probs[n, c])
    above = np.searchsorted(thresholds, probs, side="right")
    cols = np.broadcast_to(np.arange(c), (n, c))
    hist_all = np.bincount((cols * (t + 1) + above).ravel(), minlength=c * (t + 1)).reshape(c, t + 1)
    hit = target[:, None] == np.arange(c)[None, :]
    hist_pos = np.bincount((cols * (t + 1) + above)[hit], minlength=c * (t + 1)).reshape(c, t + 1)
    # count with above > k: reverse cumulative sum over k
    predpos = np.cumsum(hist_all[:, ::-1], axis=1)[:, ::-1][:, 1:].T
    tp = np.cumsum(hist_pos[:, ::-1], axis=1)[:, ::-1][:, 1:].T
    return {"acc": acc, "tp": tp, "predpos": predpos}


def slice_phase(torch, bc, label: str, n: int, c: int, t: int, batch: int) -> dict:
    """Stream through the collection on the card and on the CPU; compare."""
    from tpumetrics_torch import MetricCollection, MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
    from tpumetrics_torch.interop import export_state

    def collection(device):
        return MetricCollection(
            {
                "acc": MulticlassAccuracy(c, average="micro", validate_args=False, device=device),
                "f1": MulticlassF1Score(c, average="macro", validate_args=False, device=device),
                "auroc": MulticlassAUROC(c, thresholds=t, validate_args=False, device=device),
            },
            device=device,
        )

    batches = make_stream(n, c, batch, SEED)
    dev_batches = [(torch.from_numpy(p).cuda(), torch.from_numpy(y).cuda()) for p, y in batches]
    col = collection("cuda")
    torch.cuda.synchronize()

    bc.launches = 0  # count only the main path's launches
    update_ms = []
    for preds, target in dev_batches:
        t0 = time.perf_counter()
        col.update(preds, target)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    values = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    launches = bc.launches

    groups = [list(g) for g in col.compute_groups.values()]
    check(groups == [["acc", "f1"], ["auroc"]], f"{label}: compute groups {groups}")
    check(launches == len(batches), f"{label}: {launches} kernel launches for {len(batches)} AUROC leader updates")

    cpu = collection("cpu")
    for preds, target in batches:
        cpu.update(torch.from_numpy(preds), torch.from_numpy(target))
    cpu_values = cpu.compute()

    gpu_state, cpu_state = export_state(col), export_state(cpu)
    for leader, states in cpu_state.items():
        for name, arr in states.items():
            check(arr.dtype == np.int32, f"{label}: {leader}.{name} is {arr.dtype}, not int32")
            check(np.array_equal(gpu_state[leader][name], arr), f"{label}: {leader}.{name} differs card vs CPU")
    for key, val in values.items():
        val = val.cpu()
        check(bool(torch.isfinite(val).all()) and val.shape == cpu_values[key].shape, f"{label}: {key} = {val}")
        diff = float((val - cpu_values[key]).abs().max())
        check(diff <= 1e-6, f"{label}: {key} card {val} vs CPU {cpu_values[key]} (diff {diff})")

    ref = numpy_reference(batches, c, col["auroc"].thresholds.cpu().numpy())
    check(abs(float(values["acc"]) - ref["acc"]) <= 1e-6, f"{label}: acc {float(values['acc'])} vs numpy {ref['acc']}")
    confmat = gpu_state["auroc"]["confmat"]
    check(np.array_equal(confmat[:, :, 1, 1], ref["tp"]), f"{label}: AUROC tp counts differ from numpy")
    check(
        np.array_equal(confmat[:, :, 0, 1] + confmat[:, :, 1, 1], ref["predpos"]),
        f"{label}: AUROC predicted-positive counts differ from numpy",
    )
    # the first update runs every metric and compares states: report it apart
    steady = update_ms[1:]
    print(
        f"slice phase: {label}: {len(batches)} batches, states identical to the CPU run and to numpy counts;"
        f" acc {float(values['acc']):.6f} f1 {float(values['f1']):.6f} auroc {float(values['auroc']):.6f};"
        f" first update {update_ms[0]:.3f} ms, later updates median {np.median(steady):.3f} ms"
        f" (min {min(steady):.3f}, max {max(steady):.3f}); compute {compute_ms:.3f} ms;"
        f" kernel launches {launches}",
        flush=True,
    )
    profile_step(torch, col, dev_batches[0], label)
    return {"launches": launches, "update_ms": update_ms, "compute_ms": compute_ms}


def busy_union_us(intervals) -> float:
    """Microseconds covered by the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_step(torch, col, batch, label: str) -> None:
    """After every check: one steady (leaders-only) update and one compute,
    timed on the host clock, then each again under ``torch.profiler``. From
    that one profiled run: its wall time (host clock, from the call to the
    end of ``torch.cuda.synchronize()``), the union of its device activity
    intervals from the trace, their share of that wall time (the rest is the
    device idle, waiting on the host), and the kernels that take most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(step: str) -> float:
        t0 = time.perf_counter()
        col.update(*batch) if step == "update" else col.compute()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for step in ("update", "compute"):
        col.update(*batch)  # a fresh update, so compute is not served from its cache
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        wall_ms = run(step)
        scratch_mb = (torch.cuda.max_memory_allocated() - resident) / 2**20
        col.update(*batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_ms = run(step)
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
        busy_ms = busy_union_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
        span_ms = (max(e.time_range.end for e in device) - min(e.time_range.start for e in device)) / 1e3 if device else 0.0
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
        top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:5]
        parts = "; ".join(f"{e.key[:48]} x{e.count} {e.device_time_total:.1f} us" for e in top)
        print(
            f"profile: {label}: steady {step} {wall_ms:.3f} ms wall unprofiled; profiled run {profiled_ms:.3f} ms wall,"
            f" device busy (union of {len(device)} device intervals) {busy_ms:.3f} ms"
            f" = {100 * busy_ms / profiled_ms:.1f}% of it, first-to-last device span {span_ms:.3f} ms;"
            f" peak device memory above resident {scratch_mb:.1f} MiB;"
            f" top: {parts or 'the profiler saw no device time'}",
            flush=True,
        )


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from tpumetrics_torch.ops import _build
        from tpumetrics_torch.ops import binned_confusion as bc
    except ImportError as err:
        fail(f"the port's package is not beside this script: {err}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsum must count exactly
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs.values():
        log = lib.with_name(lib.name + ".log")
        if log.exists():
            lines = [line.strip() for line in log.read_text().splitlines() if "registers" in line or "spill" in line]
            for line in dict.fromkeys(lines):  # once each, in order
                print(f"build: {lib.name}: {line}", flush=True)

    kern = kernel_phase(torch, bc)
    imagenet = slice_phase(torch, bc, "ImageNet-1k val 50000x1000 T=200", 50000, 1000, 200, 8192)
    slice_phase(torch, bc, "bench headline 40960x128 T=64", 5 * 8192, 128, 64, 8192)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card after the runs (SM clock, power draw, power limit, temperature): {clocks}", flush=True)

    main_shape = kern["timed"]["main path 8192x1000x200"]
    report = {
        "kernels": [
            {
                "name": "binned_confusion_fused",
                "route": "cuda",
                "source": "tpumetrics_torch/csrc/binned_confusion.cu",
                "replaces": "tpumetrics/ops/binned_confusion.py:62",
                "launches": imagenet["launches"],
                "max_abs_err": kern["max_abs_err"],
                "ms": main_shape["ms"],
                "plain_ms": main_shape["plain_ms"],
                "torch_ops_hist_ms": main_shape["torch_ops_hist_ms"],  # a composite of library calls, not a port
                "bound_ms": main_shape["bound_ms"],
                "bound_by": main_shape["bound_by"],
                "library_ms": None,  # no single PyTorch call computes these counts
                "shape": [main_shape["n"], main_shape["c"], main_shape["t"]],
                "timed_shapes": kern["timed"],
                "card": smi,
            }
        ]
    }
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
