#!/usr/bin/env python3
"""How far the FID InceptionV3's 2048-d features tell images apart under random weights.

``random_inception_params`` draws every convolution with a standard deviation
of 1 / sqrt(fan_in). Each ReLU then halves the variance of the part of the
signal that depends on the image, while each folded BN adds its shift, so
deep in the stack the features of all images nearly agree. ``chip_smoke.py``'s
CIFAR-10 FID stream multiplies every convolution by He's gain sqrt(2)
(``generative_inception_params``). For both weight sets this prints, over
``--images`` images of each of the stream's two sets (``cifar_images``):
the features that are 0 on every image, the median over the other features
of their standard deviation over the images divided by their mean magnitude,
the median of the two sets' mean difference over the features' standard
deviation, and the Inception Score of the generated set (one split, the
2048 features as logits, as the stream's IS runs). Small enough for a CPU::

    python3 scripts/inception_feature_spread.py --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def spread(feats_real: np.ndarray, feats_fake: np.ndarray) -> dict:
    both = np.concatenate([feats_real, feats_fake]).astype(np.float64)
    live = np.abs(both).max(0) > 0
    cv = both[:, live].std(0) / np.abs(both[:, live]).mean(0)
    pooled = 0.5 * (feats_real.std(0) + feats_fake.std(0))[live]
    sep = np.abs(feats_real.mean(0) - feats_fake.mean(0))[live] / pooled
    x = feats_fake.astype(np.float64)
    log_p = x - x.max(1, keepdims=True)
    log_p -= np.log(np.exp(log_p).sum(1, keepdims=True))
    p = np.exp(log_p)
    kl = (p * (log_p - np.log(p.mean(0, keepdims=True)))).sum(1).mean()
    return {"dead": int((~live).sum()), "median_cv": float(np.median(cv)), "median_separation": float(np.median(sep)),
            "mean_abs": float(np.abs(both).mean()), "inception_score_one_split": float(np.exp(kl))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--images", type=int, default=16)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from tpumetrics_torch.image._inception import inception_v3_features

    torch.set_num_threads(min(4, torch.get_num_threads()))
    real = chip_smoke.cifar_images(torch, 0, args.images, device=args.device)
    fake = chip_smoke.cifar_images(torch, 1, args.images, device=args.device)
    for name, gain in (("random_inception_params", 1.0), ("generative_inception_params", chip_smoke.INCEPTION_CONV_GAIN)):
        params = {k: torch.from_numpy(v).to(args.device) for k, v in chip_smoke.generative_inception_params(gain).items()}
        forward = inception_v3_features(params, ("2048",))
        with torch.no_grad():
            fr, ff = (forward(x)[0].cpu().numpy() for x in (real, fake))
        print(json.dumps({"weights": name, "conv_gain": gain, "images_a_set": args.images, "device": args.device,
                          **spread(fr, ff)}), flush=True)


if __name__ == "__main__":
    main()
