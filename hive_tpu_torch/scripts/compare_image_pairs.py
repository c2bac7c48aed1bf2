"""Compare two folders of corresponding images and emit per-pair + mean
metrics (text or a LaTeX table), on the card.

Counterpart of ``scripts/compare_image_pairs.py``::

    python -m hive_tpu_torch.scripts.compare_image_pairs folder_a folder_b [--latex]
"""

from __future__ import annotations

import argparse
import os
from os.path import join as pjoin

import numpy as np

from hive_tpu_torch import get_device
from hive_tpu_torch.io import load_image
from hive_tpu_torch.metrics import metric_skip_notes
from hive_tpu_torch.scripts.compare_image_pair import compare_images, ensure_rgb


def compare_folders(folder_a: str, folder_b: str, device=None) -> dict:
    """Pair the folders' files in sorted order and score each pair.

    :param device: where the metrics run; default ``cuda:0``.
    """
    device = get_device(device)
    filenames_a = sorted(os.listdir(folder_a))
    filenames_b = sorted(os.listdir(folder_b))

    if len(filenames_a) != len(filenames_b):
        raise RuntimeError(f"Folders contain different image counts: "
                           f"{len(filenames_a)} vs {len(filenames_b)}")

    rows = []

    for name_a, name_b in zip(filenames_a, filenames_b):
        image_a = ensure_rgb(load_image(pjoin(folder_a, name_a)))
        image_b = ensure_rgb(load_image(pjoin(folder_b, name_b)))
        rows.append({"name": name_a, **compare_images(image_a, image_b, device=device)})

    per_metric = {metric: [row[metric] for row in rows]
                  for metric in ("ssim", "psnr", "lpips", "mifd")}
    summary = {metric: float(np.nanmean(values))
               for metric, values in per_metric.items()}

    results = {"pairs": rows, "mean": summary}
    skipped = metric_skip_notes(per_metric, device)
    if skipped:
        # Label fully-absent metrics (e.g. LPIPS without weights) instead of
        # leaving a silent NaN column.
        results["skipped"] = skipped
    return results


def to_latex(results: dict) -> str:
    lines = [r"\begin{tabular}{lrrrr}",
             r"Image & SSIM & PSNR & LPIPS & MIFD \\", r"\hline"]

    for row in results["pairs"]:
        lines.append(f"{row['name']} & {row['ssim']:.3f} & {row['psnr']:.2f} & "
                     f"{row['lpips']:.3f} & {row['mifd']:.2f} \\\\")

    mean = results["mean"]
    skipped = results.get("skipped", {})

    def cell(metric, spec):
        return skipped.get(metric) or format(mean[metric], spec)

    lines.append(r"\hline")
    lines.append(f"Mean & {cell('ssim', '.3f')} & {cell('psnr', '.2f')} & "
                 f"{cell('lpips', '.3f')} & {cell('mifd', '.2f')} \\\\")
    lines.append(r"\end{tabular}")

    return "\n".join(lines)


def main(argv=None, device=None):
    """:param device: where the metrics run; default ``cuda:0``."""
    parser = argparse.ArgumentParser(
        description="Compare folders of corresponding images.")
    parser.add_argument("folder_a", type=str)
    parser.add_argument("folder_b", type=str)
    parser.add_argument("--latex", action="store_true", help="Emit a LaTeX table.")
    args = parser.parse_args(argv)

    results = compare_folders(args.folder_a, args.folder_b, device=device)

    if args.latex:
        print(to_latex(results))
    else:
        for row in results["pairs"]:
            print(f"{row['name']}: ssim={row['ssim']:.3f} psnr={row['psnr']:.2f} "
                  f"lpips={row['lpips']:.3f} mifd={row['mifd']:.2f}")

        mean = results["mean"]
        print(f"mean: ssim={mean['ssim']:.3f} psnr={mean['psnr']:.2f} "
              f"lpips={mean['lpips']:.3f} mifd={mean['mifd']:.2f}")
        for metric, reason in results.get("skipped", {}).items():
            print(f"note: {metric} {reason}")


if __name__ == "__main__":
    main()
