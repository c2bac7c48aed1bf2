"""Reading an MP4 video as ``cv2.VideoCapture`` reads it.

:class:`VideoCapture` puts the port's pieces together: the demuxer
(:mod:`.mp4`) for the sizes, rate, frame order and samples; NVDEC on a
CUDA device (:mod:`.nvdec`) or the I_PCM reader on the CPU
(:mod:`.h264_pcm`) for the planes; the conversion of OpenCV's FFmpeg
backend (:mod:`.color`) for BGR; and OpenCV's own rotation by the display
matrix (``CAP_PROP_ORIENTATION_AUTO``, on by default), which turns the
frames and swaps the reported width and height for 90 and 270 degrees.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.image_processing import (ROTATE_90_CLOCKWISE, ROTATE_90_COUNTERCLOCKWISE,
                                             ROTATE_180, rotate)
from hive_tpu_torch.video import color, h264_pcm, mp4

# OpenCV's rotation_angle -> the cv2.rotate it applies to each frame.
_AUTO_ROTATION = {90: ROTATE_90_CLOCKWISE, 180: ROTATE_180, 270: ROTATE_90_COUNTERCLOCKWISE}


class VideoCapture:
    """An H.264 MP4 read on ``device`` (default ``cuda:0``): through NVDEC
    on a CUDA device, through the I_PCM reader on the CPU.

    :ivar width, height: ``CAP_PROP_FRAME_WIDTH`` / ``HEIGHT``.
    :ivar fps: ``CAP_PROP_FPS``.
    :ivar frame_count: the frames a ``grab()`` loop counts.
    """

    def __init__(self, path: str, device=None):
        self.path = str(path)
        self.device = get_device(device)
        self.track = mp4.read_track(self.path)
        self.length_size, sps_units, self.pps_units = mp4.parse_avcc(self.track.config)
        self.sps_units = sps_units or [unit for unit in self._nal_units(0)
                                       if unit[0] & 0x1F == h264_pcm.NAL_SPS]
        if not self.sps_units:
            raise ValueError(f"{self.path} carries no H.264 sequence parameter set")
        self.sps = h264_pcm.parse_sps(h264_pcm.unescape(self.sps_units[0]))
        self.rotation = self.track.rotation
        width, height = self.sps["width"], self.sps["height"]
        self.width, self.height = (height, width) if self.rotation in (90, 270) else (width,
                                                                                      height)
        if self.device.type == "cuda":
            self._open_nvdec()
        self.fps = self.track.fps
        self.order = self.track.display_order()
        self.frame_count = len(self.order)
        self._position = {int(sample): i for i, sample in enumerate(self.order)}

    def _open_nvdec(self) -> None:
        """Refuse the video at once when NVDEC does not open on the device
        or does not decode its size."""
        from hive_tpu_torch.video import nvdec

        try:
            caps = nvdec.decoder_caps(self.device, nvdec.H264, 16 * self.sps["mbs_w"],
                                      16 * self.sps["mbs_h"])
        except nvdec.NvdecError as e:
            raise NotImplementedError(
                f"Decoding the video {self.path} on {self.device} needs NVDEC, which did not "
                f"open here: {e} (ROADMAP.md Queue 1 item 9b). hive_tpu_torch decodes video "
                f"on the CPU (device='cpu') only in the I_PCM subset of H.264.") from e
        if not caps["fits"]:
            raise NotImplementedError(
                f"NVDEC on {self.device} does not decode the 8-bit 4:2:0 H.264 video "
                f"{self.path} at its size ({caps}) (ROADMAP.md Queue 1 item 9b).")

    def _nal_units(self, sample: int, f=None):
        if f is None:
            with open(self.path, "rb") as f:
                return self._nal_units(sample, f)
        f.seek(int(self.track.offsets[sample]))
        return mp4.split_nal_units(f.read(int(self.track.sizes[sample])), self.length_size)

    def _planes(self, begin: int, end: int) -> Iterator[Tuple[int, tuple]]:
        """(sample, (Y, U, V)) of the pictures that samples ``begin`` to
        ``end - 1`` decode to, in display order; ``begin`` is a sync
        sample."""
        with open(self.path, "rb") as f:
            def units(sample):
                nal_units = self._nal_units(sample, f)
                if sample == begin or self.track.sync[sample]:
                    nal_units = self.sps_units + self.pps_units + nal_units
                return nal_units

            if self.device.type == "cuda":
                from hive_tpu_torch.video.nvdec import NvdecDecoder

                with NvdecDecoder(self.device) as decoder:
                    for sample, *planes in decoder.decode_all(
                            (mp4.annex_b(units(s)), s) for s in range(begin, end)):
                        yield sample, tuple(planes)
                return

            decoder = h264_pcm.PcmDecoder()

            def pictures():
                for sample in range(begin, end):
                    picture = decoder.decode(units(sample))
                    if picture is not None:
                        picture.sample = sample
                        yield picture

            reorder = self.sps["reorder"]
            for picture in h264_pcm.display_order(pictures(), reorder):
                yield picture.sample, tuple(torch.from_numpy(p) for p in
                                            (picture.y, picture.u, picture.v))

    def to_bgr(self, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """A picture's planes as the BGR frame cv2 returns for it."""
        frame = color.yuv420_to_bgr(y, u, v, self.sps["full_range"], self.sps["matrix"])
        code = _AUTO_ROTATION.get(self.rotation)
        return frame if code is None else rotate(frame, code)

    def planes(self, start: int = 0, stop: Optional[int] = None) -> Iterator[tuple]:
        """The (Y, U, V) uint8 planes of frames ``start`` to ``stop - 1`` in
        display order, on the device, decoded from the sync sample at or
        before the first of them."""
        stop = self.frame_count if stop is None else min(stop, self.frame_count)
        if start >= stop:
            return
        wanted = self.order[start:stop]
        syncs = np.flatnonzero(self.track.sync[:int(wanted.min()) + 1])
        begin = int(syncs[-1]) if len(syncs) else 0
        for sample, picture in self._planes(begin, int(wanted.max()) + 1):
            position = self._position.get(sample)
            if position is not None and start <= position < stop:
                yield picture

    def frames(self, start: int = 0, stop: Optional[int] = None) -> Iterator[torch.Tensor]:
        """Frames ``start`` to ``stop - 1`` as (H, W, 3) uint8 BGR tensors on
        the device, as cv2's ``read()`` gives them."""
        for picture in self.planes(start, stop):
            yield self.to_bgr(*picture)

    def frame(self, index: int) -> torch.Tensor:
        """Frame ``index`` (0-based, display order), as
        ``set(CAP_PROP_POS_FRAMES, index)`` then ``read()`` gives it."""
        if not 0 <= index < self.frame_count:
            raise IndexError(f"frame {index} of a {self.frame_count}-frame video")
        return next(self.frames(index, index + 1))
