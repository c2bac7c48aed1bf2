"""Reading an MP4 video as ``cv2.VideoCapture`` reads it.

:class:`VideoCapture` puts the port's pieces together: the demuxer
(:mod:`.mp4`) for the codec, sizes, rate, frame selection and samples; the
host decoders of H.264 (:mod:`.h264`), HEVC (:mod:`.hevc`), Motion JPEG
(:mod:`.mjpeg`) and MPEG-4 Part 2 (:mod:`.mpeg4`) on any device, the wanted pictures' planes
then moved to the device; the conversion of
OpenCV's FFmpeg backend (:mod:`.color`) for BGR, on the device; and
OpenCV's own rotation by the display matrix (``CAP_PROP_ORIENTATION_AUTO``,
on by default), which turns the frames and swaps the reported width and
height for 90 and 270 degrees.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.image_processing import (ROTATE_90_CLOCKWISE, ROTATE_90_COUNTERCLOCKWISE,
                                             ROTATE_180, rotate)
from hive_tpu_torch.video import color, h264, hevc, mjpeg, mp4, mpeg4
from hive_tpu_torch.video.h264_bits import display_order

# OpenCV's rotation_angle -> the cv2.rotate it applies to each frame.
_AUTO_ROTATION = {90: ROTATE_90_CLOCKWISE, 180: ROTATE_180, 270: ROTATE_90_COUNTERCLOCKWISE}


class VideoCapture:
    """An H.264, HEVC, Motion JPEG or MPEG-4 Part 2 MP4 read on ``device``
    (default ``cuda:0``). Each codec decodes on the host for every device,
    in one path (NVDEC, :mod:`.nvdec`, is not used): H.264 in the I, P and B
    subset of :mod:`.h264` (CAVLC or CABAC, the 8x8 transform, scaling
    matrices, weighted prediction) and HEVC in the Main profile subset of
    :mod:`.hevc` (I, P and B slices), whose headers are all read, and
    whatever they refuse refused, when the capture opens. An MPEG-4 N-VOP
    (``vop_coded`` 0) gives no frame, as in cv2, so it is left out of the
    frames and the count; so is an HEVC picture with pic_output_flag 0, a
    RASL picture FFmpeg drops (one that leads the stream's first IRAP
    picture) and one an IDR or BLA picture's no_output_of_prior_pics_flag
    drops before it is output, and a seek decodes from an IRAP picture whose
    wanted leading pictures decode.

    :ivar width, height: ``CAP_PROP_FRAME_WIDTH`` / ``HEIGHT``.
    :ivar fps: ``CAP_PROP_FPS``.
    :ivar frame_count: the frames a ``grab()`` loop counts.
    """

    def __init__(self, path: str, device=None):
        self.path = str(path)
        self.device = get_device(device)
        self.track = mp4.read_track(self.path)
        self.codec = self.track.codec
        if self.codec == mp4.MJPEG:
            header = mjpeg.sample_header(self._sample(0))
            mjpeg.check_sample(header, self.track.coded_height)
            width, height = header["width"], header["height"]
            # JPEG is full range, its matrix BT.601: swscale's default.
            self.full_range, self.matrix = True, color.UNSPECIFIED
        elif self.codec == mp4.MPEG4:
            with open(self.path, "rb") as f:
                headers, self._coded = mpeg4.scan_track(
                    self.track.config, len(self.track.sizes),
                    lambda i, n: self._sample(i, f, n))
            width, height = headers.width, headers.height
            # yuv420p, limited range, BT.601: swscale's default, as for H.264.
            self.full_range, self.matrix = False, color.UNSPECIFIED
        else:
            if self.codec == mp4.HEVC:
                self.length_size, self.parameter_sets = hevc.parse_hvcc(self.track.config)
                scan = hevc.scan_track
            else:
                self.length_size, self.sps_units, self.pps_units = mp4.parse_avcc(
                    self.track.config)
                self.parameter_sets = self.sps_units + self.pps_units
                scan = h264.scan_track
            with open(self.path, "rb") as f:
                scanned = scan(self.parameter_sets, len(self.track.sizes),
                               lambda i: self._nal_units(i, f))
            self.sps, self.reorder, idr = scanned[:3]
            if self.codec == mp4.HEVC:
                # The samples that give a frame, and the IRAP sample each RASL
                # picture leads.
                self._coded, self._leads = scanned[3:]
            self._idr = np.zeros(len(self.track.sizes), bool)
            self._idr[idr] = True
            width, height = self.sps["width"], self.sps["height"]
            self.full_range, self.matrix = self.sps["full_range"], self.sps["matrix"]
        self.rotation = self.track.rotation
        self.width, self.height = (height, width) if self.rotation in (90, 270) else (width,
                                                                                      height)
        self.fps = self.track.fps
        self.segments = self.track.segments()
        if self.codec in (mp4.MPEG4, mp4.HEVC):
            self.segments = [segment[self._coded[segment]] for segment in self.segments]
        self.frame_count = sum(len(segment) for segment in self.segments)

    def _sample(self, sample: int, f=None, limit: Optional[int] = None) -> bytes:
        """Sample ``sample``'s bytes, or its first ``limit``."""
        if f is None:
            with open(self.path, "rb") as f:
                return self._sample(sample, f, limit)
        f.seek(int(self.track.offsets[sample]))
        size = int(self.track.sizes[sample])
        return f.read(size if limit is None else min(size, limit))

    def _nal_units(self, sample: int, f=None):
        return mp4.split_nal_units(self._sample(sample, f), self.length_size)

    def _planes(self, begin: int, wanted: np.ndarray) -> Iterator[Tuple[int, tuple]]:
        """(sample, planes) of the pictures of ``wanted`` that samples
        ``begin`` to the last of ``wanted`` decode to, in display order;
        ``begin`` is a sync sample (for H.264, an IDR picture; for HEVC, an
        IRAP picture) at or before the first of ``wanted``. Motion JPEG
        decodes the samples of ``wanted`` alone (each is a sync sample);
        MPEG-4 Part 2, H.264 and HEVC decode each sample from ``begin`` in
        order."""
        with open(self.path, "rb") as f:
            if self.codec == mp4.MPEG4:
                decoder = mpeg4.Mpeg4Decoder(self.track.config)
                keep = set(wanted.tolist())
                for sample in range(begin, int(wanted.max()) + 1):
                    planes = decoder.decode(self._sample(sample, f))
                    if planes is not None and sample in keep:
                        yield sample, tuple(torch.from_numpy(np.ascontiguousarray(p))
                                            .to(self.device) for p in planes)
                return

            if self.codec == mp4.MJPEG:
                for sample in wanted.tolist():
                    planes = mjpeg.decode_sample(self._sample(sample, f),
                                                 self.track.coded_height)
                    yield sample, tuple(torch.from_numpy(np.ascontiguousarray(p))
                                        .to(self.device) for p in planes)
                return

            # H.264 and HEVC: each sample from ``begin`` (an IDR or IRAP
            # picture) in decode order, the pictures put in display order
            # (HEVC: FFmpeg's output order, which scan_track found sorted);
            # only the wanted ones move to the device.
            decoder = hevc.HevcDecoder() if self.codec == mp4.HEVC else h264.H264Decoder()
            decoder.decode(self.parameter_sets)
            keep = set(wanted.tolist())

            def pictures():
                for sample in range(begin, int(wanted.max()) + 1):
                    picture = decoder.decode(self._nal_units(sample, f))
                    if picture is not None:
                        picture.sample = sample
                        yield picture

            ordered = (hevc.output_order(pictures(), self.sps) if self.codec == mp4.HEVC
                       else display_order(pictures(), self.reorder))
            for picture in ordered:
                if picture.sample in keep:
                    yield picture.sample, tuple(
                        torch.from_numpy(np.ascontiguousarray(p)).to(self.device)
                        for p in (picture.y, picture.u, picture.v))

    def to_bgr(self, *planes: torch.Tensor) -> torch.Tensor:
        """A picture's planes (Y, U, V, or Y alone) as the BGR frame cv2
        returns for it."""
        frame = color.planes_to_bgr(planes, self.full_range, self.matrix)
        code = _AUTO_ROTATION.get(self.rotation)
        return frame if code is None else rotate(frame, code)

    def planes(self, start: int = 0, stop: Optional[int] = None) -> Iterator[tuple]:
        """The uint8 planes (Y, U, V, or Y alone) of frames ``start`` to
        ``stop - 1`` on the device, each edit's frames decoded from the
        sync sample (for H.264, the IDR picture; for HEVC, the IRAP picture)
        at or before the first of them."""
        stop = self.frame_count if stop is None else min(stop, self.frame_count)
        first = 0
        for segment in self.segments:
            lo, hi = max(start, first), min(stop, first + len(segment))
            first += len(segment)
            if lo >= hi:
                continue
            wanted = segment[lo - (first - len(segment)):hi - (first - len(segment))]
            yield from self._segment_planes(wanted)

    def _segment_planes(self, wanted: np.ndarray) -> Iterable[tuple]:
        """The planes of ``wanted`` (samples of one edit, in display
        order)."""
        starts = self._idr if self.codec in (mp4.H264, mp4.HEVC) else self.track.sync
        syncs = np.flatnonzero(starts[:int(wanted.min()) + 1])
        if self.codec == mp4.HEVC:
            # Not an IRAP picture whose wanted RASL pictures a decode from it
            # would drop.
            while len(syncs) > 1 and np.isin(self._leads[wanted], syncs[-1]).any():
                syncs = syncs[:-1]
        begin = int(syncs[-1]) if len(syncs) else 0
        keep = set(wanted.tolist())
        for sample, picture in self._planes(begin, wanted):
            if sample in keep:
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
