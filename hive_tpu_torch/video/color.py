"""YUV 4:2:0 to BGR as ``cv2.VideoCapture``'s FFmpeg backend gives it.

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


def yuv420_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, full_range: bool = False,
                  matrix: int = UNSPECIFIED) -> torch.Tensor:
    """(H, W) Y and (H/2, W/2) U, V uint8 planes -> (H, W, 3) uint8 BGR on
    their device, as cv2's FFmpeg backend converts them."""
    yc, vr, ub, ug, vg, yo = coefficients(full_range, matrix)
    luma = (((y.to(torch.int32) << 3) - yo) * yc) >> 16
    cu = (u.to(torch.int32) << 3) - 1024
    cv = (v.to(torch.int32) << 3) - 1024
    chroma = torch.stack([(cu * ub) >> 16, ((cu * ug) >> 16) + ((cv * vg) >> 16),
                          (cv * vr) >> 16], dim=-1)
    h, w = y.shape
    chroma = chroma.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:h, :w]
    return (luma[..., None] + chroma).clamp_(0, 255).to(torch.uint8)


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
