"""One-command weight conversion for every released model checkpoint.

Counterpart of ``hive_tpu/models/convert.py``: the same command line and
the same npz files, which both packages read from ``$WEIGHTS_PATH``::

    python -m hive_tpu_torch.models.convert --all <checkpoint-dir>

converts whichever of the four released checkpoints it finds there into
``$WEIGHTS_PATH`` (or ``--output``), with the converters of
:mod:`~hive_tpu_torch.models.dpt`, :mod:`~hive_tpu_torch.models.lama`,
:mod:`~hive_tpu_torch.models.maskrcnn` and :mod:`~hive_tpu_torch.models.lpips`.

Expected file names under ``--all`` (first match wins):

=============  ====================================================  ======================
model          searched checkpoint file(s)                           output
=============  ====================================================  ======================
DPT-Hybrid     ``dpt_hybrid_nyu.pt`` | ``dpt_hybrid_nyu-*.pt``       ``dpt_hybrid_nyu.npz``
big-lama       ``big-lama.ckpt`` | ``big-lama/models/best.ckpt``     ``big-lama.npz``
               | ``best.ckpt``
Mask R-CNN     ``maskrcnn_resnet50_fpn.pth``                         ``maskrcnn_coco.npz``
               | ``maskrcnn_resnet50_fpn_coco-*.pth``
LPIPS          ``alexnet-owt-*.pth`` | ``alexnet.pth``               ``lpips_alex.npz``
               AND ``lpips_alex.pth`` | ``alex.pth``
=============  ====================================================  ======================

Torch-hub names embed an 8-hex SHA256 prefix (``…-2ce69ec7.pt``); when
present it is verified against the file before conversion. Individual
conversions take explicit paths: ``--dpt``, ``--lama``, ``--maskrcnn``,
``--lpips ALEXNET LIN_HEADS``. ``--selftest`` converts fabricated
checkpoints of the four upstream layouts and runs each converted network
(:mod:`~hive_tpu_torch.models.selftest`), on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob as globlib
import hashlib
import logging
import os
import re
import sys
from os.path import join as pjoin
from typing import List, Optional

DPT_CANDIDATES = ["dpt_hybrid_nyu.pt", "dpt_hybrid_nyu-*.pt"]
LAMA_CANDIDATES = ["big-lama.ckpt", pjoin("big-lama", "models", "best.ckpt"), "best.ckpt"]
MASKRCNN_CANDIDATES = ["maskrcnn_resnet50_fpn.pth", "maskrcnn_resnet50_fpn_coco-*.pth"]
LPIPS_ALEXNET_CANDIDATES = ["alexnet-owt-*.pth", "alexnet.pth"]
LPIPS_LIN_CANDIDATES = ["lpips_alex.pth", "alex.pth"]

DPT_OUTPUT = "dpt_hybrid_nyu.npz"
LAMA_OUTPUT = "big-lama.npz"
MASKRCNN_OUTPUT = "maskrcnn_coco.npz"
LPIPS_OUTPUT = "lpips_alex.npz"

_HUB_HASH_RE = re.compile(r"-([0-9a-f]{8,})\.(?:pt|pth)$")


def verify_hub_hash(path: str) -> Optional[bool]:
    """Check a torch-hub style ``-<hexprefix>.pt(h)`` name against the
    file's SHA256: True or False, or None when the name embeds no hash."""
    match = _HUB_HASH_RE.search(os.path.basename(path))
    if not match:
        return None

    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest().startswith(match.group(1))


def _find(base: str, candidates: List[str]) -> Optional[str]:
    for name in candidates:
        if any(ch in name for ch in "*?["):
            matches = sorted(globlib.glob(pjoin(base, name)))
            if matches:
                return matches[0]
        elif os.path.isfile(pjoin(base, name)):
            return pjoin(base, name)
    return None


def convert_dpt(checkpoint: str, output_dir: str) -> str:
    from hive_tpu_torch.models.dpt import convert_torch_checkpoint

    out = pjoin(output_dir, DPT_OUTPUT)
    convert_torch_checkpoint(checkpoint, out)
    return out


def convert_lama(checkpoint: str, output_dir: str, base_features: int = 64,
                 num_downsamples: int = 3, num_blocks: int = 18,
                 global_ratio: float = 0.75) -> str:
    from hive_tpu_torch.models.lama import convert_torch_checkpoint

    out = pjoin(output_dir, LAMA_OUTPUT)
    convert_torch_checkpoint(checkpoint, out, base_features=base_features,
                             num_downsamples=num_downsamples, num_blocks=num_blocks,
                             global_ratio=global_ratio)
    return out


def convert_maskrcnn(checkpoint: str, output_dir: str) -> str:
    from hive_tpu_torch.models.maskrcnn import convert_torch_checkpoint

    out = pjoin(output_dir, MASKRCNN_OUTPUT)
    convert_torch_checkpoint(checkpoint, out)
    return out


def convert_lpips(alexnet: str, lin_heads: str, output_dir: str) -> str:
    from hive_tpu_torch.models.lpips import convert_torch_checkpoint

    out = pjoin(output_dir, LPIPS_OUTPUT)
    convert_torch_checkpoint(alexnet, lin_heads, out)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "hive_tpu_torch.models.convert",
        description="Convert released torch checkpoints to the .npz weights that "
                    "hive_tpu and hive_tpu_torch read (any subset).")
    parser.add_argument("--all", metavar="DIR", default=None,
                        help="Folder to search for the four released checkpoints by their "
                             "expected file names; converts every one it finds.")
    parser.add_argument("--dpt", metavar="PT", default=None,
                        help="Path to the released dpt_hybrid_nyu.pt.")
    parser.add_argument("--lama", metavar="CKPT", default=None,
                        help="Path to the released big-lama best.ckpt.")
    parser.add_argument("--maskrcnn", metavar="PTH", default=None,
                        help="Path to a torchvision maskrcnn_resnet50_fpn state dict.")
    parser.add_argument("--lpips", metavar=("ALEXNET", "LIN"), nargs=2, default=None,
                        help="Paths to torchvision's alexnet-owt .pth and the lpips "
                             "package's weights/v0.1/alex.pth.")
    parser.add_argument("--output", metavar="DIR", default=None,
                        help="Output folder for the .npz files (default: $WEIGHTS_PATH, "
                             "else ./weights).")
    parser.add_argument("--lama_base_features", type=int, default=64)
    parser.add_argument("--lama_num_downsamples", type=int, default=3)
    parser.add_argument("--lama_num_blocks", type=int, default=18)
    parser.add_argument("--lama_global_ratio", type=float, default=0.75)
    parser.add_argument("--selftest", action="store_true",
                        help="Fabricate all four upstream checkpoint layouts with random "
                             "tensors, convert, run each network and check it: run this "
                             "first when validating the conversion tooling.")
    parser.add_argument("--device", default=None,
                        help="Where --selftest runs the networks (default: cuda:0).")
    args = parser.parse_args(argv)

    if args.selftest:
        from hive_tpu_torch.models import selftest

        return 1 if selftest.run_selftest(device=args.device) else 0

    if not (args.all or args.dpt or args.lama or args.maskrcnn or args.lpips):
        parser.error("nothing to do: pass --all DIR or at least one of "
                     "--dpt/--lama/--maskrcnn/--lpips")

    output_dir = args.output or os.environ.get("WEIGHTS_PATH", "weights")
    os.makedirs(output_dir, exist_ok=True)

    # Explicit paths win; --all fills in the rest by search.
    dpt_path, lama_path, maskrcnn_path = args.dpt, args.lama, args.maskrcnn
    lpips_paths = tuple(args.lpips) if args.lpips else None

    if args.all:
        if not os.path.isdir(args.all):
            parser.error(f"--all: {args.all} is not a folder")
        dpt_path = dpt_path or _find(args.all, DPT_CANDIDATES)
        lama_path = lama_path or _find(args.all, LAMA_CANDIDATES)
        maskrcnn_path = maskrcnn_path or _find(args.all, MASKRCNN_CANDIDATES)
        if lpips_paths is None:
            alexnet = _find(args.all, LPIPS_ALEXNET_CANDIDATES)
            lin = _find(args.all, LPIPS_LIN_CANDIDATES)
            if alexnet and lin:
                lpips_paths = (alexnet, lin)

    jobs = []
    if dpt_path:
        jobs.append(("dpt", lambda: convert_dpt(dpt_path, output_dir)))
    if lama_path:
        jobs.append(("lama", lambda: convert_lama(
            lama_path, output_dir, base_features=args.lama_base_features,
            num_downsamples=args.lama_num_downsamples, num_blocks=args.lama_num_blocks,
            global_ratio=args.lama_global_ratio)))
    if maskrcnn_path:
        jobs.append(("maskrcnn", lambda: convert_maskrcnn(maskrcnn_path, output_dir)))
    if lpips_paths:
        jobs.append(("lpips", lambda: convert_lpips(lpips_paths[0], lpips_paths[1],
                                                    output_dir)))

    if not jobs:
        print("No checkpoints found. Expected file names:", file=sys.stderr)
        print(f"  DPT:       {' | '.join(DPT_CANDIDATES)}\n"
              f"  big-lama:  {' | '.join(LAMA_CANDIDATES)}\n"
              f"  Mask R-CNN: {' | '.join(MASKRCNN_CANDIDATES)}\n"
              f"  LPIPS:     ({' | '.join(LPIPS_ALEXNET_CANDIDATES)}) + "
              f"({' | '.join(LPIPS_LIN_CANDIDATES)})", file=sys.stderr)
        return 1

    # A torch-hub name embeds a SHA256 prefix: refuse a corrupt or renamed
    # download before a converter misreads it.
    for label, path in [("dpt", dpt_path), ("maskrcnn", maskrcnn_path),
                        ("lpips alexnet", lpips_paths[0] if lpips_paths else None),
                        ("lpips lin", lpips_paths[1] if lpips_paths else None)]:
        if path and verify_hub_hash(path) is False:
            print(f"[FAILED] {label}: {path} does not match the SHA256 prefix embedded in "
                  f"its file name (corrupt download?)", file=sys.stderr)
            return 1

    failures = 0
    for name, job in jobs:
        try:
            print(f"[ok] {name}: wrote {job()}")
        except Exception as exc:  # noqa: BLE001 — convert the rest, report all
            failures += 1
            logging.exception(f"{name} conversion failed")
            print(f"[FAILED] {name}: {type(exc).__name__}: {exc}", file=sys.stderr)

    skipped = [label for label, present in [("dpt", dpt_path), ("lama", lama_path),
                                            ("maskrcnn", maskrcnn_path),
                                            ("lpips", lpips_paths)]
               if not present]
    if skipped:
        print(f"[skipped] no checkpoint found for: {', '.join(skipped)}")

    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
