"""What chip_smoke.py's HEVC checks see of planted decoder faults.

    python tests/torch_hevc_planted_faults.py --work DIR                 # the exerciser clips
    python tests/torch_hevc_planted_faults.py --work DIR --clips phone   # and the 1080p clip

The card's machine has no cv2, so ``chip_smoke.py`` holds the HEVC decoder
built there by digests (the written file and cv2's frames) of the 1080p
x265-shaped phone clip (``PHONE_HEVC_DIGESTS``) and of the VGA exerciser
clips (``HEVC_EXERCISER_DIGESTS``), and by the phone clip's luma PSNR
against the renders it was written from (``PHONE_HEVC_MIN_PSNR``). The writer shares the decoder's prediction and
residual coding, so a fault there is mostly written into the stream too and
hides from a PSNR. This script copies ``hive_tpu_torch`` and
``chip_smoke.py`` into ``DIR`` once per variant, plants one fault in the
copy of ``native/src/hevc_decode.cpp`` or ``hevc_tables.h`` (the sound copy plants none; the
``loop_filter_counting`` copy makes the loop filters count their decisions
on every decode, which changes no output), builds it, and prints for each:
with ``--clips phone``, whether the phone clip's file and frames keep their
digests, its PSNR on its checked frames and the host ms to decode its IDR,
a P, a reference B and a non-reference B picture (best of 3); whether each exerciser clip's file and frames keep
their digests; and, where cv2 is installed, how many frames cv2 reads
otherwise than the port. Not a test: the readings are written down in
PERF.md.
"""

import argparse
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODER = os.path.join("hive_tpu_torch", "native", "src", "hevc_decode.cpp")
TABLES = os.path.join("hive_tpu_torch", "native", "src", "hevc_tables.h")

# name -> [(file, its text, the replacement), ...]; None: the sound build.
VARIANTS = {
    "sound": None,
    # The DC and the horizontal / vertical boundary filters of luma below
    # 32x32 (8.4.4.2.6) left out.
    "edge_filters_skipped": [(DECODER, "            if (c == 0 && n < 32) {\n                out[0]",
                              "            if (false) {\n                out[0]"),
                             (DECODER, "        if (c == 0 && n < 32) {\n            if (mode == 26)",
                              "        if (false) {\n            if (mode == 26)")],
    # SAO's 135 and 45 degree edge classes swapped (8.7.3.2, Table 8-13).
    "sao_135_45_swapped": [(DECODER, "{{-1, -1}, {1, 1}},\n                                         "
                            "{{1, -1}, {-1, 1}}};",
                            "{{1, -1}, {-1, 1}},\n                                         "
                            "{{-1, -1}, {1, 1}}};")],
    # Sign data hiding's parity inverted, in the decoder and in the writer's
    # plan alike (a misreading both sides would share).
    "sign_hiding_parity_inverted": [(DECODER, "if (k == first_sig && (sum & 1)) v = -v;",
                                     "if (k == first_sig && !(sum & 1)) v = -v;"),
                                    (DECODER, "if ((*lv[first] < 0) != (sum & 1)) {",
                                     "if ((*lv[first] < 0) == (sum & 1)) {")],
    # Strong intra smoothing's threshold one above 1 << (BitDepthY - 5).
    "strong_smoothing_threshold_9": [(DECODER, "std::abs(corner + right - 2 * line[3 * n]) < 8 &&",
                                      "std::abs(corner + right - 2 * line[3 * n]) < 9 &&"),
                                     (DECODER, "std::abs(corner + bottom - 2 * line[n]) < 8) {",
                                      "std::abs(corner + bottom - 2 * line[n]) < 9) {")],
    # The quarter-sample luma filter's centre taps 58, 17 as 57, 18 (Table
    # 8-11; the sum stays 64).
    "interpolation_tap": [(TABLES, "{-1, 4, -10, 58, 17, -5, 1, 0}",
                           "{-1, 4, -10, 57, 18, -5, 1, 0}")],
    # The merge list's first two spatial candidates in the order B1, A1
    # (8.5.3.2.2 puts A1 first).
    "merge_order_b1_a1": [(DECODER, "        if (a1) list[n++] = motion(xa1, ya1);\n", ""),
                          (DECODER, "motion(xb1, yb1)))) list[n++] = motion(xb1, yb1);\n",
                           "motion(xb1, yb1)))) list[n++] = motion(xb1, yb1);\n"
                           "        if (a1) list[n++] = motion(xa1, ya1);\n")],
    # The collocated vector scaled by the inverse ratio (td and tb swapped,
    # 8-179 to 8-183).
    "tmvp_scaling_swapped": [(DECODER, "out = scale_mv(mv, col_diff, cur_diff);",
                              "out = scale_mv(mv, cur_diff, col_diff);")],
    # bS 1 only for vectors more than 4 quarter samples apart (8.7.2.4 says
    # at least 4).
    "inter_bs_threshold": [(DECODER, "return std::abs(a.x - b.x) >= 4 || std::abs(a.y - b.y) >= 4;",
                            "return std::abs(a.x - b.x) > 4 || std::abs(a.y - b.y) > 4;")],
    # Explicit uni-prediction weights without their rounding offset
    # (8-252 adds 2^(log2WD - 1) before the shift).
    "weighted_rounding_dropped": [(DECODER, "((a * r.w[c] + (1 << (shift - 1))) >> shift)",
                                   "((a * r.w[c]) >> shift)")],
    # Not a fault: the loop filters count their decisions on every decode,
    # not only when the caller asks; read for what counting costs the
    # phone clip's decode.
    "loop_filter_counting": [(DECODER, "    if (filter_stats)\n        LoopFilter<true>",
                              "    int64_t local[kLfStats] = {};\n    if (!filter_stats) "
                              "filter_stats = local;\n    if (filter_stats)\n"
                              "        LoopFilter<true>")],
}

CHILD = r"""
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import numpy as np
import chip_smoke as cs
from hive_tpu_torch.video import hevc
from hive_tpu_torch.video.capture import VideoCapture
try:
    import cv2
except ImportError:
    cv2 = None

def unlike_cv2(path, ours):
    if cv2 is None:
        return None
    capture, theirs = cv2.VideoCapture(path), []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        theirs.append(frame)
    return sum(not np.array_equal(a, b) for a, b in zip(ours, theirs)) + abs(len(ours) - len(theirs))

out = {}
with tempfile.TemporaryDirectory() as folder:
    if "phone" in sys.argv[1].split(","):
        path = os.path.join(folder, "phone.mp4")
        _, _, frames = cs.write_hevc_phone_clip(path)
        capture = VideoCapture(path, device="cpu")
        want = cs.PHONE_HEVC_DIGESTS
        out["phone_file_held"] = cs.file_digest(path) == want[0]
        out["phone_frames_held"] = cs.frames_digest(list(capture.frames())) == want[1]
        out["phone_psnr"] = {i: cs.psnr_db(next(capture.planes(i, i + 1))[0].numpy(), frames[i][0])
                             for i in cs.PHONE_HEVC_CHECKED}
        out["phone_decode_ms"] = dict(zip(("idr", "p", "b_reference", "b"),
                                          cs.hevc_decode_ms(capture)[1]))
    for index, (name, *_) in enumerate(cs.HEVC_EXERCISER_CLIPS):
        try:
            path, _ = cs.write_hevc_exerciser(folder, index)
        except ValueError as e:
            out[name] = dict(writer_failed=str(e))
            continue
        frames = [f.numpy() for f in VideoCapture(path, device="cpu").frames()]
        want = cs.HEVC_EXERCISER_DIGESTS[name]
        out[name] = dict(file_held=cs.file_digest(path) == want[0],
                         frames_held=cs.frames_digest(frames) == want[1],
                         frames_unlike_cv2=unlike_cv2(path, frames))
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
    parser.add_argument("--clips", default="",
                        help="'phone' to read the 1080p phone clip too (its render and write "
                             "take most of the time)")
    args = parser.parse_args()
    for name in args.only:
        child = subprocess.run([sys.executable, "-c", CHILD, args.clips],
                               cwd=prepare(args.work, name), stdout=subprocess.PIPE, text=True)
        if child.returncode:
            raise SystemExit(f"{name}: exit {child.returncode}")
        print(name, child.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
