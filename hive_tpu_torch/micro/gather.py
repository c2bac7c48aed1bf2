"""Gather probes on the card: the port of ``scripts/micro_pallas_gather.py``.

    python -m hive_tpu_torch.micro.gather [--device cpu]

Q1  Both tile gathers (``ops/tile_gather.py``, the counterparts of the
    TPU's lane and sublane gathers of an (8, 128) tile) equal numpy's
    ``take_along_axis``.
Q2  The window patch gather (``ops/patch_gather.py``): NB = 1024 blocks of
    512 samples, each from its block's 16 x 256 window of a VGA frame,
    equal numpy's gather. On the card it is timed beside ``torch.take`` and
    the port's band sampler (``ops/band_sampler.py``) on the same samples:
    one timed call gathers from REPS frames that differ.

It runs on ``cuda:0`` unless ``--device cpu`` is passed; on the CPU the
wrappers take their plain versions and it prints correctness only. It
exits non-zero when a result is wrong.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.micro.timing import device_profile, events_ms
from hive_tpu_torch.ops.band_sampler import band_sample
from hive_tpu_torch.ops.patch_gather import patch_gather
from hive_tpu_torch.ops.tile_gather import tile_gather

H, W = 480, 640
PH = 16           # patch rows per block window
PW = 256          # patch columns
BV = 512          # samples per block
NB = 1024         # blocks per call (512K samples)
REPS = 8          # frames per timed call


def q1_inputs():
    """The probe's (8, 128) tile of 32-bit words (as int32) and its lane
    (axis 1) and sublane (axis 0) indices."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 2 ** 31, (8, 128)).astype(np.uint32).view(np.int32)
    idx = rng.integers(0, 128, (8, 128)).astype(np.int32)
    ridx = rng.integers(0, 8, (8, 128)).astype(np.int32)
    return src, idx, ridx


def q1(device: torch.device):
    """(lane exact, sublane exact)."""
    src, idx, ridx = q1_inputs()
    results = []
    for label, axis, index in (("lane", 1, idx), ("sublane", 0, ridx)):
        out = tile_gather(torch.as_tensor(src, device=device),
                          torch.as_tensor(index, device=device), axis)
        ok = np.array_equal(out.cpu().numpy(), np.take_along_axis(src, index, axis=axis))
        print(f"Q1 {label} gather (take_along_axis axis={axis} on (8,128)): "
              f"{'OK exact' if ok else 'WRONG VALUES'}")
        results.append(ok)
    return tuple(results)


def q2_inputs():
    """A frame of random words and NB block footprints: 128-aligned window
    origins and in-window sample coordinates, (NB, BV // 128, 128)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64).astype(np.uint32)
    v0 = rng.integers(0, H - PH, NB).astype(np.int32)
    u0 = (rng.integers(0, (W - PW) // 128, NB) * 128).astype(np.int32)
    vv = (v0[:, None] + rng.integers(0, PH, (NB, BV))).astype(np.int32)
    uu = (u0[:, None] + rng.integers(0, PW, (NB, BV))).astype(np.int32)
    shape = (NB, BV // 128, 128)
    return img.view(np.int32), v0, u0, vv.reshape(shape), uu.reshape(shape)


def q2(device: torch.device) -> dict:
    """Exactness, and on the card each gather's device ms, launch-loop ms and
    device operations per timed call."""
    img, v0, u0, vv, uu = q2_inputs()
    frame, v0_t, u0_t, vv_t, uu_t = (torch.as_tensor(x, device=device)
                                     for x in (img, v0, u0, vv, uu))
    out = patch_gather(v0_t, u0_t, frame, vv_t, uu_t, PH, PW)
    exact = np.array_equal(out.cpu().numpy(), img[vv, uu])
    print(f"Q2 patch gather ({NB} blocks x {BV} samples, {PH}x{PW} windows): "
          f"{'values exact' if exact else 'VALUES WRONG'}")
    result = {"exact": exact}
    if device.type != "cuda" or not exact:
        print("(correctness only: timing needs the card)")
        return result

    frames = [frame ^ r for r in range(REPS)]
    flat = (vv_t.long() * W + uu_t.long()).contiguous()
    gathers = {
        "patch_gather": lambda f: patch_gather(v0_t, u0_t, f, vv_t, uu_t, PH, PW),
        "take": lambda f: torch.take(f, flat),
        "band_sample": lambda f: band_sample(f, vv_t, uu_t),
    }
    samples = NB * BV * REPS
    for name, gather in gathers.items():
        def call(gather=gather):
            return [gather(f) for f in frames]
        device_ms, ops = device_profile(call, reps=20)
        loop_ms = events_ms(call, reps=20)
        result[name] = {"device_ms": device_ms, "loop_ms": loop_ms, "device_ops": ops}
        print(f"Q2 {name:12s}: {device_ms:9.5f} ms device ({device_ms / samples * 1e6:7.4f} "
              f"ns/sample, {ops:.0f} device ops), {loop_ms:9.5f} ms launch loop, per "
              f"{REPS} frames")
    print(f"Q2 take / patch_gather device time: "
          f"{result['take']['device_ms'] / result['patch_gather']['device_ms']:.2f}x")
    return result


def run(device: torch.device) -> dict:
    ok_lane, ok_sub = q1(device)
    result = {"q1": {"lane": ok_lane, "sublane": ok_sub}}
    if ok_lane:
        result["q2"] = q2(device)
    result["ok"] = ok_lane and ok_sub and result.get("q2", {}).get("exact", False)
    return result


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu (correctness only)")
    args = parser.parse_args(argv)
    device = get_device(args.device)
    print(f"device: {describe(device)}")
    return 0 if run(device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
