"""What chip_smoke.py's H.264 checks see of planted decoder faults.

    python tests/torch_h264_planted_faults.py --work DIR   # a few minutes a variant, one at a time

The card's machine has no cv2, so ``chip_smoke.py`` holds the H.264
decoder built there by four means: the 1080p CAVLC phone clip's luma PSNR
against the renders it was written from (``PHONE_H264_MIN_PSNR``), the
x264-shaped 1080p phone clip's (B pictures; ``PHONE_H264_B_MIN_PSNR``), the
1920x1440 Stray Scanner capture's (High profile, CABAC, the 8x8 transform;
``STRAY_MIN_PSNR``), and the VGA exerciser clips' digests
(``H264_EXERCISER_DIGESTS``: the written file and cv2's frames). The
writer rebuilds its references with the port's own decoder and shares its
prediction code, so a fault in the decoder is mostly written into the
stream too and hides from a PSNR. This script copies ``hive_tpu_torch``
and ``chip_smoke.py`` into ``DIR`` once per variant, plants one fault in
the copy (``native/src/h264_decode.cpp`` or ``video/h264.py``; the sound
copy plants none), builds it, and prints for each: the phone clips' and
the Stray capture's PSNR on their checked frames, how many of their 30
frames cv2 reads otherwise than the port, and whether each exerciser
clip's file and frames keep their digests. ``--clips`` names the rendered
clips to read (the 1080p and 1920x1440 ones take most of the time). Not a
test: the readings are written down in PERF.md.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODER = os.path.join("hive_tpu_torch", "native", "src", "h264_decode.cpp")
READER = os.path.join("hive_tpu_torch", "video", "h264.py")
FLAT = "[(16,) * 16] * 6 + [(16,) * 64] * 2"

# name -> [(file, its text, the replacement), ...]; None: the sound build.
VARIANTS = {
    "sound": None,
    "deblocking_off": [(DECODER,
                        "for (int mx = 0; mx < mbw; ++mx) deblock_mb(st, mbw, mx, my, planes);",
                        "for (int mx = 0; mx < mbw; ++mx) (void)planes;")],
    "six_tap_21_19": [(DECODER, "return a - 5 * b + 20 * cc + 20 * d - 5 * e + f;",
                       "return a - 5 * b + 21 * cc + 19 * d - 5 * e + f;")],
    "chroma_qp_offset_ignored": [(DECODER, "return kChromaQp[clip3(0, 51, qp + offset)];",
                                  "return kChromaQp[clip3(0, 51, qp)];")],
    # n of ctxIdx 60 (mb_qp_delta's first bin) in the cabac_init_idc 1 table
    # one more than Table 9-15's.
    "cabac_init_idc_1_entry": [(DECODER,
                                "const int pre = clip3(1, 126, ((t[k][0] * q) >> 4) + t[k][1]);",
                                "const int pre = clip3(1, 126, ((t[k][0] * q) >> 4) + t[k][1] + "
                                "(slice_type == 0 && init_idc == 1 && k == 60));")],
    "internal_8x8_edges_filtered": [(DECODER,
                                     "if ((e == 0 && !outer) || (q.t8x8 && (e & 1))) continue;",
                                     "if (e == 0 && !outer) continue;")],
    "intra_8x8_unfiltered": [(DECODER,
                              "auto P = [&](int x, int y) { return y < 0 ? top[1 + x] : left[y]; };",
                              "auto P = [&](int x, int y) { return y < 0 ? (x < 0 ? Q : T[x]) : "
                              "L[y]; };")],
    "fall_back_a_flat": [(READER, 'lists = _fall_back(sps["scaling"], DEFAULT_LISTS)',
                          f'lists = _fall_back(sps["scaling"], {FLAT})'),
                         (READER, 'DEFAULT_LISTS if sps["scaling"] is None else lists',
                          f'{FLAT} if sps["scaling"] is None else lists')],
    # Faults only B slices reach: temporal direct's DistScaleFactor one
    # more; implicit weights taken as the default average; the bS rule
    # comparing list 0 alone.
    "temporal_scale_plus_one": [(DECODER, "const int scale = temporal_scale[ref[0]];",
                                 "const int scale = temporal_scale[ref[0]] + 1;")],
    "implicit_weights_default": [(DECODER,
                                  "implicit_w0[r0][r1] = plain ? 32 : 64 - (w >> 2);",
                                  "implicit_w0[r0][r1] = plain ? 32 : 32;")],
    "bs_list0_only": [(DECODER, "    if (!straight) return 0;\n    if (p0 != q1 || p1 != q0) return 1;",
                       "    return p0 != q0 || far(p.mv[0][pb], q.mv[0][qb]) ? 1 : 0;\n"
                       "    if (!straight) return 0;\n    if (p0 != q1 || p1 != q0) return 1;")],
}

CHILD = r"""
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import cv2
import numpy as np
import chip_smoke as cs
from hive_tpu_torch.video.capture import VideoCapture

def cv2_frames(path):
    capture, frames = cv2.VideoCapture(path), []
    while True:
        ok, frame = capture.read()
        if not ok:
            return frames
        frames.append(frame)

def clip_readings(out, name, path, rendered, checked):
    capture = VideoCapture(path, device="cpu")
    out[name + "_psnr"] = {i: cs.psnr_db(next(capture.planes(i, i + 1))[0].numpy(),
                                         rendered[i]) for i in checked}
    ours = [f.numpy() for f in capture.frames()]
    theirs = cv2_frames(path)
    out[name + "_frames_unlike_cv2"] = sum(not np.array_equal(a, b) for a, b in zip(ours, theirs))
    out[name + "_frames"] = [len(ours), len(theirs)]

out = {}
with tempfile.TemporaryDirectory() as folder:
    for clip in sys.argv[1].split(","):
        path = os.path.join(folder, clip + ".mp4")
        if clip == "phone":
            _, _, frames = cs.write_h264_phone_clip(path)
            clip_readings(out, clip, path, {i: f[0] for i, f in enumerate(frames)},
                          cs.PHONE_H264_CHECKED)
        elif clip == "phone_b":
            _, _, frames = cs.write_h264_b_phone_clip(path)
            clip_readings(out, clip, path, {i: f[0] for i, f in enumerate(frames)},
                          cs.PHONE_H264_B_CHECKED)
        elif clip == "stray":
            stray = os.path.join(folder, "stray")
            _, rendered = cs.write_stray_capture(stray, cs.VIDEO_FRAMES)
            clip_readings(out, clip, os.path.join(stray, "rgb.mp4"), rendered, cs.STRAY_CHECKED)
    for index, (name, *_) in enumerate(cs.H264_EXERCISER_CLIPS):
        path, _ = cs.write_h264_exerciser(folder, index)
        frames = [f.numpy() for f in VideoCapture(path, device="cpu").frames()]
        want = cs.H264_EXERCISER_DIGESTS[name]
        out[name] = dict(file_held=cs.file_digest(path) == want[0],
                         frames_held=cs.frames_digest(frames) == want[1],
                         frames_unlike_cv2=sum(not np.array_equal(a, b) for a, b in
                                               zip(frames, cv2_frames(path))))
print(json.dumps(out))
"""


def prepare(work: str, name: str) -> str:
    """A copy of the package and the script with ``name``'s fault planted."""
    root = os.path.join(work, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "hive_tpu_torch"), os.path.join(root, "hive_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
    for source, old, new in VARIANTS[name] or ():
        path = os.path.join(root, source)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to change is not in {source} once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--work", required=True, help="a folder for the copies")
    parser.add_argument("--only", nargs="*", default=list(VARIANTS), choices=list(VARIANTS))
    parser.add_argument("--clips", default="phone,phone_b,stray",
                        help="the rendered clips to read besides the exerciser clips: any of "
                        "phone, phone_b, stray, comma-separated")
    args = parser.parse_args()
    for name in args.only:
        child = subprocess.run([sys.executable, "-c", CHILD, args.clips],
                               cwd=prepare(args.work, name), stdout=subprocess.PIPE, text=True)
        if child.returncode:
            raise SystemExit(f"{name}: exit {child.returncode}")
        print(name, child.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
