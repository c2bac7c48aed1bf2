"""Compare two images with SSIM, PSNR, LPIPS and MIFD, on the card.

Counterpart of ``scripts/compare_image_pair.py`` (the same metrics, output
and refusals)::

    python -m hive_tpu_torch.scripts.compare_image_pair a.png b.jpg [--json]

SSIM and PSNR are ``metrics.ssim_psnr`` (float64 on the device), LPIPS and
MIFD the port's scorers on the same device. Images are read by
``io.load_image``.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np

from hive_tpu_torch import get_device
from hive_tpu_torch.io import load_image
from hive_tpu_torch.metrics import lpips, lpips_available, mifd, ssim_psnr


def compare_images(image_a, image_b, device=None) -> dict:
    """SSIM, PSNR, LPIPS and MIFD of two images of one shape.

    :param device: where the metrics run; default ``cuda:0``.
    """
    device = get_device(device)
    ssim_value, psnr_value = ssim_psnr(image_a, image_b, device=device)
    return {
        "ssim": ssim_value,
        "psnr": psnr_value,
        "lpips": lpips(image_a, image_b, device=device),
        "mifd": mifd(image_a, image_b, device=device),
    }


def ensure_rgb(image):
    """Normalise any loaded image to (H, W, 3): grayscale broadcasts, RGBA
    drops alpha (the metrics, LPIPS especially, expect 3 channels)."""
    image = np.asarray(image)
    if image.ndim == 2:
        return np.repeat(image[..., None], 3, axis=-1)
    return image[..., :3]


def main(argv=None, device=None):
    """:param device: where the metrics run; default ``cuda:0``."""
    parser = argparse.ArgumentParser(
        description="Compare two images with SSIM, PSNR, LPIPS and MIFD.")
    parser.add_argument("image_a", type=str, help="Path to the first image.")
    parser.add_argument("image_b", type=str, help="Path to the second image.")
    parser.add_argument("--json", action="store_true", help="Emit JSON instead of text.")
    args = parser.parse_args(argv)
    device = get_device(device)

    image_a = ensure_rgb(load_image(args.image_a))
    image_b = ensure_rgb(load_image(args.image_b))

    if image_a.shape != image_b.shape:
        raise RuntimeError(f"Image shapes differ: {image_a.shape} vs {image_b.shape}")

    results = compare_images(image_a, image_b, device=device)

    if args.json:
        # Strict JSON has neither NaN nor Infinity (identical images give
        # PSNR = inf): non-finite values become null.
        clean = {k: (None if not math.isfinite(v) else v) for k, v in results.items()}
        if not lpips_available(device):
            clean["skipped"] = {"lpips": "skipped: weights absent"}
        print(json.dumps(clean))
    else:
        for metric, value in results.items():
            if metric == "lpips" and value != value and not lpips_available(device):
                print(f"{metric.upper():>6}: skipped (weights absent)")
            else:
                print(f"{metric.upper():>6}: {value:.4f}")


if __name__ == "__main__":
    main()
