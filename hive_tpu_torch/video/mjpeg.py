"""Motion JPEG samples decoded as FFmpeg's ``mjpeg`` decoder decodes them,
so as ``cv2.VideoCapture`` reads a Motion JPEG ``.mp4``.

Each sample is one JPEG. :func:`decode_sample` runs the port's JPEG scan
decoder (``image_codecs.decode_jpeg_planes``: the marker parser, the
Huffman decode, native or numpy) with FFmpeg's integer "simple" IDCT in
place of libjpeg's islow, and stops before any upsampling or colour
conversion: the planes are FFmpeg's full-range ``yuvj420p``, ``yuvj422p``,
``yuvj444p`` or ``gray`` frame, which :func:`video.color.planes_to_bgr`
converts as swscale does. Against cv2 5.0.0's wheel (its FFmpeg on x86-64)
the planes are bit-equal to FFmpeg's: its SIMD IDCT gives the C
``simple_idct``'s pixels, so no tolerance is needed.

Samples without a DHT segment take the standard Huffman tables, as FFmpeg
does. The ``AVI1`` APP0 segment of AVI-style Motion JPEG only names field
polarity, which matters only for interlaced samples; those (a frame
header less than three quarters as tall as the track, FFmpeg's test for
two fields) are refused by name, as are chroma layouts FFmpeg would decode
to formats other than the four above, subsampled chroma at an odd height
(where swscale interpolates the chroma) and RGB-coded JPEGs.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from hive_tpu_torch.image_codecs import decode_jpeg_planes
from hive_tpu_torch.video.mp4 import OTHER_CODEC_ITEM, UnsupportedVideoError

# Chroma size ratios (rows, columns) against luma, by FFmpeg pixel format.
LAYOUTS = {(2, 2): "yuvj420p", (1, 2): "yuvj422p", (1, 1): "yuvj444p"}


def sample_header(blob: bytes) -> dict:
    """The frame header of a JPEG sample, read up to its first scan:
    ``width``, ``height``, ``sampling`` ((h, v) per component), ``ids``,
    ``avi1`` (the AVI1 segment's polarity byte, or None) and ``adobe``
    (the Adobe segment's transform byte, or None)."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError("a Motion JPEG sample that is not a JPEG (no SOI marker)")
    header = dict(avi1=None, adobe=None)
    pos = 2
    while pos + 4 <= len(blob):
        if blob[pos] != 0xFF:
            raise ValueError(f"corrupt Motion JPEG sample: expected a marker at byte {pos}")
        marker = blob[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xDA, 0xD9):                          # SOS, EOI
            break
        (length,) = struct.unpack(">H", blob[pos + 2:pos + 4])
        body = blob[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xE0 and body[:4] == b"AVI1":
            header["avi1"] = body[4] if len(body) > 4 else 0
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            header["adobe"] = body[11]
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            _, height, width, count = struct.unpack(">BHHB", body[:6])
            header.update(width=width, height=height,
                          ids=[body[6 + 3 * i] for i in range(count)],
                          sampling=[(body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15)
                                    for i in range(count)])
    if "width" not in header:
        raise ValueError("a Motion JPEG sample with no frame header")
    return header


def check_sample(header: dict, coded_height: int) -> None:
    """Refuse, by name, what FFmpeg decodes to something other than one
    progressive-scan ``yuvj`` / ``gray`` picture of the frame's size."""
    if header["height"] < coded_height * 3 // 4:
        raise UnsupportedVideoError(
            f"The video is interlaced Motion JPEG: each sample holds one field of "
            f"{header['height']} of the track's {coded_height} lines (two-field samples"
            f"{'' if header['avi1'] is None else ', AVI1 polarity %d' % header['avi1']}); "
            f"hive_tpu_torch decodes progressive Motion JPEG only (ROADMAP.md "
            f"{OTHER_CODEC_ITEM}).")
    if len(header["sampling"]) == 3 and (header["adobe"] == 0
                                         or header["ids"] == [ord("R"), ord("G"), ord("B")]):
        raise UnsupportedVideoError(
            f"The video is RGB-coded Motion JPEG; hive_tpu_torch decodes YCbCr and grey "
            f"Motion JPEG only (ROADMAP.md {OTHER_CODEC_ITEM}).")
    if len(header["sampling"]) == 3:
        (yh, yv), *chroma = header["sampling"]
        ratios = {(yv // v, yh // h) if yv % v == 0 and yh % h == 0 else None
                  for h, v in chroma}
        layout = ratios.pop() if len(ratios) == 1 else None
        if layout not in LAYOUTS:
            raise UnsupportedVideoError(
                f"The video's Motion JPEG samples have sampling factors "
                f"{header['sampling']}; hive_tpu_torch decodes 4:2:0, 4:2:2, 4:4:4 and grey "
                f"only (ROADMAP.md {OTHER_CODEC_ITEM}).")
        if layout != (1, 1) and header["height"] % 2:
            # swscale leaves its unscaled converter for odd heights and
            # interpolates the chroma: a path the port does not mirror.
            raise UnsupportedVideoError(
                f"The video's Motion JPEG samples are {LAYOUTS[layout]} of odd height "
                f"({header['height']}); hive_tpu_torch converts odd heights only at 4:4:4 "
                f"or grey (ROADMAP.md {OTHER_CODEC_ITEM}).")


def decode_sample(blob: bytes, coded_height: int,
                  native: Optional[bool] = None) -> List[np.ndarray]:
    """One Motion JPEG sample -> its uint8 planes as FFmpeg's decoder gives
    them: Y alone for a grey sample, else Y, Cb and Cr (full range)."""
    check_sample(sample_header(blob), coded_height)
    return decode_jpeg_planes(blob, native, idct="simple").planes
