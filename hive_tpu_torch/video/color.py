"""YUV to BGR as ``cv2.VideoCapture``'s FFmpeg backend gives it.

OpenCV converts the decoder's ``yuv420p`` frames to ``BGR24`` with
``sws_scale`` at the same size. A sweep of every (Y, U, V) triple through
OpenCV 5.0.0's Python wheel (its FFmpeg has swscale 9.5) showed:

* each BGR pixel is a function of its own Y and of the U and V of its 2 x 2
  block alone: the chroma is repeated, not interpolated (two layouts of the
  16.7M triples, with different neighbours, gave the same table);
* swscale's x86 path computes it in 16-bit fixed point, which this module
  does in integer torch ops, on the card and on the CPU alike::

      y = ((Y << 3) - y_offset) * y_coeff >> 16
      u = (U << 3) - 1024,  v = (V << 3) - 1024
      B = y + (u * ub >> 16)
      G = y + ((u * ug >> 16) + (v * vg >> 16))
      R = y + (v * vr >> 16)              each clamped to [0, 255]

  with the coefficients of ``ff_yuv2rgb_c_init_tables`` (libswscale
  ``yuv2rgb.c``): ``ff_yuv2rgb_coeffs`` for the SPS's
  ``matrix_coefficients``, scaled by 255 / 219 for limited-range luma or by
  224 / 255 for full-range chroma, each rounded by ``roundToInt16(x <<
  13)``. It equals that cv2's conversion on all 16,777,216 triples for
  limited and full range, with the BT.601 (unspecified) and BT.709 colour
  descriptions, and at frame widths that are not multiples of 16.

cv2 honours the VUI's ``video_full_range_flag`` and ``matrix_coefficients``,
so the port does too (:func:`coefficients`). Matrices this table does not
hold (BT.2020 and later) are refused.

Motion JPEG decodes to full-range ``yuvj420p``, ``yuvj422p``, ``yuvj444p``
or ``gray``; checked against this cv2 on Pillow-written samples:

* 4:2:2 takes the same arithmetic, its chroma repeated along rows only;
* 4:4:4 takes swscale's other path: chroma that is not subsampled forces
  its full-chroma output (``SWS_FULL_CHR_H_INT``, ``yuv2rgb_write_full``
  in ``output.c``), 30-bit sums of the 15-bit intermediates::

      Y = ((Y << 9) - y_offset) * y_coeff + 2^21
      u = (U - 128) << 9,  v = (V - 128) << 9
      B = Y + u * ub,  G = Y + v * vg + u * ug,  R = Y + v * vr
      each clamped to [0, 2^30 - 1], then >> 22

  with the same coefficients and ``y_offset = roundToInt16(oy << 9)``;
* grey is the plane in all three channels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# libswscale's ff_yuv2rgb_coeffs rows (crv, cbu, cgu, cgv), x 65536, by the
# H.264 VUI's matrix_coefficients; 2 (unspecified) is swscale's default.
_COEFFS = {1: (117489, 138438, 13975, 34925),    # BT.709
           2: (104597, 132201, 25675, 53279),    # unspecified: BT.601
           3: (104597, 132201, 25675, 53279),    # reserved
           4: (104448, 132798, 24759, 53109),    # FCC
           5: (104597, 132201, 25675, 53279),    # BT.470 B/G
           6: (104597, 132201, 25675, 53279),    # SMPTE 170M
           7: (117579, 136230, 16907, 35559)}    # SMPTE 240M
UNSPECIFIED = 2


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // b
    return q if a >= 0 else -q


def _round_to_int16(f: int) -> int:
    return max(-0x7FFF, min(0x7FFF, (f + (1 << 15)) >> 16))


def coefficients(full_range: bool = False, matrix: int = UNSPECIFIED) -> Tuple[int, ...]:
    """(y_coeff, vr, ub, ug, vg, y_offset) of swscale's 16-bit path."""
    if matrix not in _COEFFS:
        raise ValueError(f"The video's colour matrix (matrix_coefficients {matrix}) is not one "
                         f"hive_tpu_torch converts (BT.601, BT.709, FCC, SMPTE 240M)")
    crv, cbu, cgu, cgv = _COEFFS[matrix]
    cgu, cgv = -cgu, -cgv
    cy, oy = 1 << 16, 0
    if full_range:
        crv, cbu, cgu, cgv = (_trunc_div(c * 224, 255) for c in (crv, cbu, cgu, cgv))
    else:
        cy, oy = (cy * 255) // 219, 16 << 16
    return tuple(_round_to_int16(c << 13) for c in (cy, crv, cbu, cgu, cgv)) + (
        _round_to_int16(oy << 3),)


def _subsampled_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, rows: int,
                       full_range: bool, matrix: int) -> torch.Tensor:
    """swscale's 16-bit path, each chroma sample repeated over ``rows`` rows
    and two columns."""
    yc, vr, ub, ug, vg, yo = coefficients(full_range, matrix)
    luma = (((y.to(torch.int32) << 3) - yo) * yc) >> 16
    cu = (u.to(torch.int32) << 3) - 1024
    cv = (v.to(torch.int32) << 3) - 1024
    chroma = torch.stack([(cu * ub) >> 16, ((cu * ug) >> 16) + ((cv * vg) >> 16),
                          (cv * vr) >> 16], dim=-1)
    h, w = y.shape
    chroma = chroma.repeat_interleave(rows, dim=0).repeat_interleave(2, dim=1)[:h, :w]
    return (luma[..., None] + chroma).clamp_(0, 255).to(torch.uint8)


def yuv420_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, full_range: bool = False,
                  matrix: int = UNSPECIFIED) -> torch.Tensor:
    """(H, W) Y and (H/2, W/2) U, V uint8 planes -> (H, W, 3) uint8 BGR on
    their device, as cv2's FFmpeg backend converts them."""
    return _subsampled_to_bgr(y, u, v, 2, full_range, matrix)


def yuv422_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, full_range: bool = False,
                  matrix: int = UNSPECIFIED) -> torch.Tensor:
    """(H, W) Y and (H, W/2) U, V uint8 planes -> (H, W, 3) uint8 BGR, as
    :func:`yuv420_to_bgr` with the chroma repeated along rows only."""
    return _subsampled_to_bgr(y, u, v, 1, full_range, matrix)


def yuv444_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, full_range: bool = False,
                  matrix: int = UNSPECIFIED) -> torch.Tensor:
    """(H, W) Y, U and V uint8 planes -> (H, W, 3) uint8 BGR through
    swscale's full-chroma output (the module's docstring)."""
    yc, vr, ub, ug, vg, _ = coefficients(full_range, matrix)
    yo = 0 if full_range else _round_to_int16((16 << 16) << 9)
    luma = ((y.to(torch.int32) << 9) - yo) * yc + (1 << 21)
    cu = (u.to(torch.int32) - 128) << 9
    cv = (v.to(torch.int32) - 128) << 9
    bgr = torch.stack([luma + cu * ub, luma + cv * vg + cu * ug, luma + cv * vr], dim=-1)
    return (bgr.clamp_(0, (1 << 30) - 1) >> 22).to(torch.uint8)


def grey_to_bgr(y: torch.Tensor) -> torch.Tensor:
    """An (H, W) uint8 grey plane -> (H, W, 3) uint8 BGR: swscale's ``gray``
    to ``bgr24`` copies it into each channel."""
    return y[..., None].expand(*y.shape, 3).contiguous()


def planes_to_bgr(planes, full_range: bool = False, matrix: int = UNSPECIFIED) -> torch.Tensor:
    """Grey (one plane) or Y, U, V planes at 4:2:0, 4:2:2 or 4:4:4, told
    apart by the chroma planes' size, -> (H, W, 3) uint8 BGR."""
    if len(planes) == 1:
        return grey_to_bgr(planes[0])
    y, u, v = planes
    (h, w), (ch, cw) = y.shape, u.shape
    layout = (-(-h // ch), -(-w // cw))
    convert = {(2, 2): yuv420_to_bgr, (1, 2): yuv422_to_bgr, (1, 1): yuv444_to_bgr}.get(layout)
    if convert is None:
        raise ValueError(f"chroma planes of {ch}x{cw} for a {h}x{w} picture are not 4:2:0, "
                         f"4:2:2 or 4:4:4")
    return convert(y, u, v, full_range, matrix)


def rgb_to_yuv420(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB (H, W even) -> limited-range BT.601 Y, U, V
    planes, the chroma averaged over each 2 x 2 block: a way to make video
    fixtures from rendered frames (not a counterpart of any cv2 call)."""
    rgb = np.asarray(rgb, np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    cb = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    cr = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    h, w = y.shape

    def half(plane):
        return plane.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    return tuple(np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in (y, half(cb), half(cr)))
