"""The derivation behind ``hive_tpu_torch/video/color.py``: every (Y, U, V)
triple through cv2.VideoCapture's YUV 4:2:0 -> BGR conversion.

    python tests/torch_video_sweep.py      # ~1 min and ~2 GB on one core

For each variant (limited / full range, BT.601 / BT.709 colour description)
it writes two I_PCM MP4s of 16 frames of 1024 x 1024, which hold all 65,536
(U, V) pairs, each with 64 2 x 2 blocks of luma that give all 256 Y values:
the first in order, the second with the blocks shuffled (other
neighbours). It decodes both with cv2, prints how many triples the two
layouts convert differently (0: each pixel depends on its own Y and its
block's U and V alone) and how many ``color.yuv420_to_bgr`` converts
otherwise than cv2 (0: the formula is exact). Not a test: the tests hold
the formula on a seeded sample (tests/test_torch_video.py).
"""

import os
import sys
import tempfile

import cv2
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hive_tpu_torch.video import color, h264  # noqa: E402

SIDE = 1024
FRAMES = 16


def sweep_frames(shuffle_seed=None):
    blocks = np.arange(65536 * 64)
    pair, j = blocks // 64, blocks % 64
    u, v = (pair >> 8).astype(np.uint8), (pair & 255).astype(np.uint8)
    ys = (4 * j[:, None] + np.arange(4)).astype(np.uint8)
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        order = rng.permutation(len(blocks))
        u, v, ys = u[order], v[order], ys[order]
        ys = np.take_along_axis(ys, np.argsort(rng.random(ys.shape), 1), 1)
    per = (SIDE // 2) ** 2
    half = SIDE // 2
    return [(ys[f * per:(f + 1) * per].reshape(half, half, 2, 2).transpose(0, 2, 1, 3)
             .reshape(SIDE, SIDE), u[f * per:(f + 1) * per].reshape(half, half),
             v[f * per:(f + 1) * per].reshape(half, half)) for f in range(FRAMES)]


def triple_table(frames, decoded):
    """(Y, U, V) -> BGR from one sweep."""
    table = np.zeros((256, 256, 256, 3), np.uint8)
    for (y, u, v), bgr in zip(frames, decoded):
        uu = np.repeat(np.repeat(u, 2, 0), 2, 1)
        vv = np.repeat(np.repeat(v, 2, 0), 2, 1)
        table[y.ravel(), uu.ravel(), vv.ravel()] = bgr.reshape(-1, 3)
    return table


def decode(path):
    capture = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return frames


def port_table(full_range, matrix):
    u, v = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                       indexing="ij")
    table = np.zeros((256, 256, 256, 3), np.uint8)
    for y in range(256):
        planes = (torch.full((512, 512), y, dtype=torch.uint8),
                  torch.from_numpy(u), torch.from_numpy(v))
        table[y] = color.yuv420_to_bgr(*planes, full_range, matrix).numpy()[::2, ::2]
    return table


def main():
    with tempfile.TemporaryDirectory() as tmp:
        for full_range, matrix in ((False, None), (True, None), (False, 1), (True, 1)):
            tables = []
            for name, seed in (("ordered", None), ("shuffled", 7)):
                frames = sweep_frames(seed)
                path = os.path.join(tmp, f"{name}.mp4")
                height, width = frames[0][0].shape
                h264.write_h264_mp4(path, frames, h264.PcmPlanner(width, height),
                                    full_range=full_range, matrix=matrix)
                tables.append(triple_table(frames, decode(path)))
            layouts = int((tables[0] != tables[1]).any(-1).sum())
            ours = port_table(full_range, color.UNSPECIFIED if matrix is None else matrix)
            differ = (ours != tables[0]).any(-1)
            largest = int(np.abs(ours.astype(int) - tables[0]).max())
            print(f"full_range={full_range} matrix={matrix}: triples the two layouts convert "
                  f"differently {layouts}; triples the port converts otherwise than cv2 "
                  f"{int(differ.sum())} of {differ.size} (largest difference {largest})",
                  flush=True)


if __name__ == "__main__":
    main()
