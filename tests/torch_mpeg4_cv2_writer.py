"""What cv2's ``mp4v`` writer makes of ``chip_smoke.py``'s 1080p phone clip,
beside the port's own MPEG-4 Part 2 clip of the same frames.

    python tests/torch_mpeg4_cv2_writer.py      # ~10 s, needs cv2

It writes the 30 wall frames of ``chip_smoke.write_mpeg4_phone_clip`` once
with that function (the clip ``[video]`` decodes on the card) and once with
``cv2.VideoWriter(..., "mp4v", 30, (1920, 1080))`` from the same planes.
For each file it prints, as one JSON object: whether the VOL allows video
packets (``resync_marker_disable`` 0), the user data, each VOP's type,
``vop_quant`` and bytes, and the luma PSNR of the frames ``[video]``
checks against the planes they were written from, decoded by the port on
the CPU. Not a test: the tests hold the decoder to cv2's frames
(tests/test_torch_mpeg4.py).
"""

import json
import os
import sys
import tempfile

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from hive_tpu_torch.video import mp4, mpeg4  # noqa: E402
from hive_tpu_torch.video.capture import VideoCapture  # noqa: E402


def survey(path, planes):
    track = mp4.read_track(path)
    decoder = mpeg4.Mpeg4Decoder(track.config)
    vops = []
    with open(path, "rb") as f:
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            vop = decoder.check(f.read(int(size)))
            vops.append(("IP"[vop.coding_type], vop.qscale, int(size)))
    capture = VideoCapture(path, device="cpu")
    psnr = {index: chip_smoke.psnr_db(next(capture.planes(index, index + 1))[0].numpy(),
                                      planes[index][0])
            for index in chip_smoke.PHONE_MPEG4_CHECKED}
    headers = decoder.headers
    return dict(bytes=os.path.getsize(path), resync_markers=headers.resync_markers,
                user_data=[u.decode("latin-1") for u in headers.user_data],
                vop_quant=sorted({q for _, q, _ in vops}),
                vops=["%s q%d %d B" % v for v in vops], luma_psnr_db=psnr)


def main():
    with tempfile.TemporaryDirectory() as folder:
        port_path, cv2_path = (os.path.join(folder, name) for name in ("port.mp4", "cv2.mp4"))
        _, _, planes = chip_smoke.write_mpeg4_phone_clip(port_path)
        height, width = planes[0][0].shape
        writer = cv2.VideoWriter(cv2_path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (width, height))
        for y, u, v in planes:
            i420 = np.concatenate([y.ravel(), u.ravel(), v.ravel()]).reshape(-1, width)
            writer.write(cv2.cvtColor(i420, cv2.COLOR_YUV2BGR_I420))
        writer.release()
        print(json.dumps(dict(size=[width, height], port=survey(port_path, planes),
                              cv2=survey(cv2_path, planes)), indent=1))


if __name__ == "__main__":
    main()
