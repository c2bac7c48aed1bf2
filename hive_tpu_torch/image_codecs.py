"""PNG and JPEG codecs in numpy and zlib, where the JAX package uses Pillow.

The card's machine has no Pillow, OpenCV or imageio, so the port encodes the
textures of its glTF files, its depth PNGs and its converted frames itself,
and decodes the frames it reads:

* :func:`encode_png`: 8-bit grey, grey+alpha, RGB and RGBA, and 16-bit grey;
  non-interlaced, one filter per row picked by the smallest sum of absolute
  filtered bytes (libpng's heuristic), zlib level 6. Lossless; the decoder
  is ``hive_tpu_torch.io.decode_png``.
* :func:`encode_jpeg`: baseline sequential JFIF, YCbCr 4:2:0, the IJG
  quality-scaled quantisation tables and the standard Huffman tables of the
  JPEG specification (Annex K), libjpeg's fixed-point colour conversion,
  downsampling, edge padding and integer "islow" DCT: the bytes Pillow
  (libjpeg-turbo) writes for ``save(format="JPEG", quality=q)``.
* :func:`write_image`: a frame to a file, JPEG or PNG by its extension.
* :func:`decode_jpeg`: baseline, extended sequential and progressive Huffman
  JPEGs with one or three components, interleaved or not, any sampling
  factors of 1 or 2, restart intervals; libjpeg's integer "islow" IDCT,
  fancy chroma upsampling and fixed-point YCbCr -> RGB, so the pixels are
  those Pillow (libjpeg-turbo) decodes. :func:`decode_jpeg_planes` stops
  before the upsampling and takes either IDCT: islow, or FFmpeg's "simple"
  IDCT, whose planes are those FFmpeg's MJPEG decoder (so cv2's
  ``VideoCapture``) gives. Progressive scans (DC and AC, first
  and refinement, with end-of-band runs) fill the quantised coefficients of
  every block, which then take the baseline path's IDCT. Arithmetic-coded,
  lossless, hierarchical and four-component files are refused.

Entropy coding is vectorised: every Huffman code and its extra bits become
one token, the tokens are sorted into scan order and expanded into bits with
numpy. Decoding runs the Huffman decode, dequantisation and IDCT in the
native library (``native/src/jpeg_decode.cpp``); its plain version is a
Python loop over symbols with a 16-bit lookup table and a numpy IDCT. A
progressive file's scans are Huffman-decoded into coefficients the same two
ways, and its IDCT is the numpy one in both.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# PNG.
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels -> PNG colour type: grey, grey+alpha, RGB, RGBA.
_PNG_COLOUR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_filter_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Filter each scanline of ``raw`` (H, stride) uint8 with the PNG filter
    (0-4) whose bytes, read as signed, have the smallest absolute sum; return
    (H, stride + 1) with the filter type in column 0. Filters read the
    unfiltered neighbours, so all rows are filtered at once."""
    x = raw.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up_left = np.zeros_like(x)
    up_left[1:, bpp:] = x[:-1, :-bpp]

    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))

    candidates = np.stack([x, x - left, x - up, x - ((left + up) >> 1), x - paeth]) & 0xFF
    signed = candidates.astype(np.uint8).view(np.int8).astype(np.int32)
    best = np.abs(signed).sum(axis=2).argmin(axis=0)              # (H,)

    rows = np.arange(raw.shape[0])
    out = np.empty((raw.shape[0], raw.shape[1] + 1), np.uint8)
    out[:, 0] = best
    out[:, 1:] = candidates[best, rows]
    return out


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """Encode an image as a PNG.

    :param image: (H, W) uint8 or uint16 grey, or (H, W, C) uint8 with C = 2
        (grey + alpha), 3 (RGB) or 4 (RGBA).
    :param level: zlib compression level.
    :return: the PNG file's bytes.
    """
    image = np.asarray(image)
    if image.ndim == 2:
        channels = 1
    elif image.ndim == 3 and image.shape[2] in (2, 3, 4):
        channels = image.shape[2]
    else:
        raise ValueError(f"cannot encode an image of shape {image.shape} as PNG")
    if image.dtype == np.uint16 and channels == 1:
        depth = 16
        raw = image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1)
    elif image.dtype == np.uint8:
        depth = 8
        raw = np.ascontiguousarray(image).reshape(image.shape[0], -1)
    else:
        raise ValueError(f"cannot encode {image.dtype} with {channels} channels as PNG")

    height, width = image.shape[:2]
    bpp = channels * depth // 8
    filtered = _png_filter_rows(raw, bpp) if height and width else raw
    header = struct.pack(">IIBBBBB", width, height, depth, _PNG_COLOUR_TYPES[channels],
                         0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + _png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# JPEG tables (ITU-T T.81 Annex K).
# ---------------------------------------------------------------------------

# ZIGZAG[i] is the natural (row-major) index of the i-th coefficient in
# zigzag order.
ZIGZAG = np.array(sorted(range(64), key=lambda n: (
    n // 8 + n % 8, (n // 8) if (n // 8 + n % 8) % 2 else (n % 8))), dtype=np.int64)

_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], dtype=np.int64)

_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, dtype=np.int64)

# Code counts per length 1..16 and the symbols, in order: DC luminance, DC
# chrominance, AC luminance, AC chrominance.
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], list(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], list(bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")))


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """The IJG quantisation tables for ``quality`` (1-100), in natural
    order, limited to 8-bit entries as a baseline file needs."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((base * scale + 50) // 100, 1, 255)
                 for base in (_LUMA_QUANT, _CHROMA_QUANT))


def _huffman_codes(spec) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol 0-255 from the counts per length (Annex C)."""
    counts, symbols = spec
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _dht_segment(table_class: int, table_id: int, spec) -> bytes:
    counts, symbols = spec
    body = bytes([table_class << 4 | table_id]) + bytes(counts) + bytes(symbols)
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


# libjpeg's 13-bit fixed-point constants of the islow DCTs (jfdctint.c,
# jidctint.c).
_CONST_BITS, _PASS1_BITS = 13, 2


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------------
# JPEG encoder.
# ---------------------------------------------------------------------------

def _rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """libjpeg's fixed-point JFIF conversion (jccolor.c), (H, W, 3) int64."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16

    def fix(x):
        return int(x * 65536 + 0.5)

    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return np.stack([y, cb, cr], axis=-1)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _fdct_pass(x: np.ndarray, axis: int, first: bool) -> np.ndarray:
    """One 8-point pass of libjpeg's integer "islow" forward DCT
    (jfdctint.c) along ``axis``: rows first, scaled up by 2**PASS1_BITS,
    then columns, which leave the result scaled up by 8."""
    d = [np.take(x, k, axis=axis) for k in range(8)]
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]

    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0], out[4] = (tmp10 + tmp11) << _PASS1_BITS, (tmp10 - tmp11) << _PASS1_BITS
        shift = _CONST_BITS - _PASS1_BITS
    else:
        out[0], out[4] = _descale(tmp10 + tmp11, _PASS1_BITS), _descale(tmp10 - tmp11, _PASS1_BITS)
        shift = _CONST_BITS + _PASS1_BITS
    z1 = (tmp12 + tmp13) * 4433                 # FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * 6270, shift)  # FIX_0_765366865
    out[6] = _descale(z1 + tmp12 * -15137, shift)  # FIX_1_847759065

    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return np.stack(out, axis=axis)


def _forward_dct_quantised(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """libjpeg's islow DCT of each level-shifted 8x8 block, quantised as
    jcdctmgr.c does (divide by 8 * q, rounding half away from zero);
    (H/8, W/8, 64) in zigzag order."""
    blocks = _blocks(plane).astype(np.int64) - 128
    coeffs = _fdct_pass(_fdct_pass(blocks, axis=-1, first=True), axis=-2, first=False)
    divisor = table.reshape(8, 8) * 8
    quantised = np.sign(coeffs) * ((np.abs(coeffs) + (divisor >> 1)) // divisor)
    return quantised.reshape(*quantised.shape[:2], 64)[..., ZIGZAG]


def _bit_size(values: np.ndarray) -> np.ndarray:
    """The JPEG magnitude category: bits needed for |value| (0 for 0)."""
    magnitude = np.abs(values)
    size = np.zeros(values.shape, np.int64)
    nonzero = magnitude > 0
    size[nonzero] = np.floor(np.log2(magnitude[nonzero])).astype(np.int64) + 1
    return size


def _extra_bits(values: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The value's bits as JPEG appends them after its code: the value if
    positive, else its one's complement in ``size`` bits."""
    return np.where(values >= 0, values, values + (1 << size) - 1)


def _entropy_tokens(zz: np.ndarray, luma: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Every code of the scan as (bits, length) tokens, in scan order.

    :param zz: (N, 64) quantised blocks in scan order, zigzag order, with the
        DC coefficient already replaced by its difference from the previous
        block of the same component.
    :param luma: (N,) bool, True where the block uses the luminance tables.
    """
    dc_tables = [_huffman_codes(_DC_CHROMA), _huffman_codes(_DC_LUMA)]
    ac_tables = [_huffman_codes(_AC_CHROMA), _huffman_codes(_AC_LUMA)]
    table = luma.astype(np.int64)
    n = zz.shape[0]

    def lookup(tables, which, symbols):
        codes = np.where(which == 1, tables[1][0][symbols], tables[0][0][symbols])
        lengths = np.where(which == 1, tables[1][1][symbols], tables[0][1][symbols])
        return codes, lengths

    # DC: code of the size, then the bits.
    dc = zz[:, 0]
    size = _bit_size(dc)
    code, length = lookup(dc_tables, table, size)
    dc_bits = (code << size) | _extra_bits(dc, size)
    dc_len = length + size
    dc_key = np.arange(n) * 65

    # AC: each nonzero coefficient after a run of zeros; runs past 15 first
    # emit ZRL codes (symbol 0xF0), folded into the same token.
    block, pos = np.nonzero(zz[:, 1:])
    pos = pos + 1
    previous = np.zeros_like(pos)
    follows = np.nonzero(block[1:] == block[:-1])[0] + 1
    previous[follows] = pos[follows - 1]
    run = pos - previous - 1
    values = zz[block, pos]
    size = _bit_size(values)
    which = table[block]
    code, length = lookup(ac_tables, which, (run % 16) * 16 + size)
    zrl_code, zrl_len = lookup(ac_tables, which, np.full_like(run, 0xF0))
    ac_bits = np.zeros_like(code)
    ac_len = np.zeros_like(code)
    for j in range(3):
        zrl = run // 16 > j
        ac_bits = np.where(zrl, (ac_bits << zrl_len) | zrl_code, ac_bits)
        ac_len = np.where(zrl, ac_len + zrl_len, ac_len)
    ac_bits = (((ac_bits << length) | code) << size) | _extra_bits(values, size)
    ac_len = ac_len + length + size
    ac_key = block * 65 + pos

    # EOB after the last nonzero coefficient unless that is coefficient 63.
    last = np.zeros(n, np.int64)
    np.maximum.at(last, block, pos)
    eob_blocks = np.nonzero(last < 63)[0]
    eob_bits, eob_len = lookup(ac_tables, table[eob_blocks], np.zeros_like(eob_blocks))
    eob_key = eob_blocks * 65 + 64

    keys = np.concatenate([dc_key, ac_key, eob_key])
    order = np.argsort(keys, kind="stable")
    bits = np.concatenate([dc_bits, ac_bits, eob_bits])[order]
    lengths = np.concatenate([dc_len, ac_len, eob_len])[order]
    return bits, lengths


def _pack_tokens(bits: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate (bits, length) tokens MSB first, pad the last byte with
    ones and stuff a zero byte after every 0xFF."""
    total = int(lengths.sum())
    token = np.repeat(np.arange(len(lengths)), lengths)
    starts = np.cumsum(lengths) - lengths
    within = np.arange(total) - starts[token]
    stream = ((bits[token] >> (lengths[token] - 1 - within)) & 1).astype(np.uint8)
    stream = np.concatenate([stream, np.ones((-total) % 8, np.uint8)])
    packed = np.packbits(stream)
    ff = np.nonzero(packed == 0xFF)[0]
    return np.insert(packed, ff + 1, 0).tobytes()


def encode_jpeg(image: np.ndarray, quality: int = 92) -> bytes:
    """Encode an RGB image as a baseline 4:2:0 JFIF JPEG.

    :param image: (H, W, 3) uint8 RGB.
    :param quality: IJG quality, 1-100.
    :return: the JPEG file's bytes.
    """
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 RGB; got {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"a JPEG cannot hold a {width}x{height} image")

    ycc = _rgb_to_ycbcr(image)
    luma_table, chroma_table = quality_tables(quality)
    my, mx = -(-height // 16), -(-width // 16)                      # MCUs
    luma_rows, luma_cols = -(-height // 8), -(-width // 8)          # luma blocks

    # The edges as libjpeg pads them (jcsample.c, jcprepct.c): the luma plane
    # repeats its last column to whole blocks and its last row to whole MCUs.
    luma = np.pad(ycc[..., 0], ((0, 16 * my - height), (0, 8 * luma_cols - width)),
                  mode="edge")
    # Chroma repeats the last column to whole MCUs and the last row to an
    # even count, is averaged 2x2 with the alternating 1, 2 rounding bias,
    # then repeats its own last row to whole MCUs.
    full = np.pad(ycc[..., 1:], ((0, height % 2), (0, 16 * mx - width), (0, 0)), mode="edge")
    h2 = full.shape[0] // 2
    bias = np.tile([1, 2], mx * 4)[:, None]
    halves = (full.reshape(h2, 2, 8 * mx, 2, 2).sum(axis=(1, 3)) + bias) >> 2
    halves = np.pad(halves, ((0, 8 * my - h2), (0, 0), (0, 0)), mode="edge")

    y_blocks = np.zeros((2 * my, 2 * mx, 64), np.int64)
    y_blocks[:, :luma_cols] = _forward_dct_quantised(luma, luma_table)
    # libjpeg codes the luma blocks of an MCU that lie past the image as
    # dummies (jccoefct.c): all AC zero, the DC of the block before them in
    # the MCU, which for a bottom row is the MCU's top right block.
    if luma_cols % 2:
        y_blocks[:, -1, 0] = y_blocks[:, -2, 0]
    if luma_rows % 2:
        y_blocks[-1] = 0
        y_blocks[-1, :, 0] = np.repeat(y_blocks[-2, 1::2, 0], 2)
    cb_blocks, cr_blocks = (_forward_dct_quantised(halves[..., c], chroma_table)
                            for c in (0, 1))

    # Scan order: per MCU the four luminance blocks row by row, Cb, Cr.
    y_mcu = y_blocks.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    per_component = [y_mcu.reshape(-1, 64), cb_blocks.reshape(-1, 64),
                     cr_blocks.reshape(-1, 64)]
    for blocks in per_component:
        dc = blocks[:, 0].copy()
        blocks[1:, 0] = dc[1:] - dc[:-1]
    zz = np.concatenate([per_component[0].reshape(my * mx, 4, 64),
                         per_component[1][:, None], per_component[2][:, None]], axis=1)
    luma = np.tile([True] * 4 + [False] * 2, my * mx)
    scan = _pack_tokens(*_entropy_tokens(zz.reshape(-1, 64), luma))

    def segment(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    jfif = segment(0xE0, b"JFIF\x00\x01\x01\x00" + struct.pack(">HH", 1, 1) + b"\x00\x00")
    dqt = (segment(0xDB, b"\x00" + bytes(luma_table[ZIGZAG].tolist()))
           + segment(0xDB, b"\x01" + bytes(chroma_table[ZIGZAG].tolist())))
    sof = segment(0xC0, struct.pack(">BHHB", 8, height, width, 3)
                  + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    dht = (_dht_segment(0, 0, _DC_LUMA) + _dht_segment(1, 0, _AC_LUMA)
           + _dht_segment(0, 1, _DC_CHROMA) + _dht_segment(1, 1, _AC_CHROMA))
    sos = segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return b"\xff\xd8" + jfif + dqt + sof + dht + sos + scan + b"\xff\xd9"


# ---------------------------------------------------------------------------
# JPEG decoder.
# ---------------------------------------------------------------------------

def _lookup_table(counts: List[int], symbols: List[int]) -> Tuple[list, list]:
    """A 16-bit lookahead table: for every 16-bit window, the symbol whose
    code starts it and that code's length (0 where no code matches)."""
    symbol_of = np.zeros(1 << 16, np.int64)
    length_of = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            symbol_of[lo:hi], length_of[lo:hi] = symbols[k], length
            code += 1
            k += 1
        code <<= 1
    return symbol_of.tolist(), length_of.tolist()


def _windows(data: bytes) -> list:
    """For each bit position of ``data``, the 16 bits starting there (ones
    past the end, as a decoder pads)."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    bits = np.concatenate([bits, np.ones(32, np.uint8)]).astype(np.int64)
    n = len(bits) - 16
    window = np.zeros(n, np.int64)
    for j in range(16):
        window |= bits[j:j + n] << (15 - j)
    return window.tolist()


def _extend(value: int, size: int) -> int:
    return value - (1 << size) + 1 if value < (1 << (size - 1)) else value


def _decode_scan(segments: List[bytes], comps: list, mcus: Tuple[int, int],
                 restart: int, coeffs: Dict[int, np.ndarray]) -> None:
    """Huffman-decode an interleaved baseline scan into ``coeffs`` (component
    id -> (rows, cols, 64) zigzag arrays, filled in place)."""
    mcu_rows, mcu_cols = mcus
    total = mcu_rows * mcu_cols
    flat = {c["id"]: [0] * coeffs[c["id"]].size for c in comps}
    mcu, segment = 0, 0
    while mcu < total:
        if segment >= len(segments):
            raise ValueError("JPEG scan ends before its last MCU")
        window = _windows(segments[segment])
        segment += 1
        pos = 0
        predictions = {c["id"]: 0 for c in comps}
        stop = total if not restart else min(total, mcu + restart)
        while mcu < stop:
            row, col = divmod(mcu, mcu_cols)
            for c in comps:
                cols = coeffs[c["id"]].shape[1]
                out = flat[c["id"]]
                dc_sym, dc_len = c["dc"]
                ac_sym, ac_len = c["ac"]
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        base = ((row * c["v"] + by) * cols + col * c["h"] + bx) * 64
                        w = window[pos]
                        size = dc_sym[w]
                        if dc_len[w] == 0:
                            raise ValueError("corrupt JPEG: no DC code matches")
                        if size > 15:
                            raise ValueError("corrupt JPEG: DC magnitude category over 15")
                        pos += dc_len[w]
                        diff = 0
                        if size:
                            diff = _extend(window[pos] >> (16 - size), size)
                            pos += size
                        predictions[c["id"]] += diff
                        out[base] = predictions[c["id"]]
                        k = 1
                        while k < 64:
                            w = window[pos]
                            symbol = ac_sym[w]
                            if ac_len[w] == 0:
                                raise ValueError("corrupt JPEG: no AC code matches")
                            pos += ac_len[w]
                            run, size = symbol >> 4, symbol & 15
                            if size == 0:
                                if run != 15:
                                    break                   # EOB
                                k += 16                     # ZRL
                                continue
                            k += run
                            if k > 63:
                                raise ValueError("corrupt JPEG: coefficient past 63")
                            out[base + k] = _extend(window[pos] >> (16 - size), size)
                            pos += size
                            k += 1
            mcu += 1
    for c in comps:
        coeffs[c["id"]][...] = np.asarray(flat[c["id"]], np.int64).reshape(
            coeffs[c["id"]].shape)


def _progressive_blocks(comps: list, mcus: Tuple[int, int]):
    """For each MCU of a scan, the (component id, block row, block col) of
    its blocks, in coding order."""
    mcu_rows, mcu_cols = mcus
    for mcu in range(mcu_rows * mcu_cols):
        row, col = divmod(mcu, mcu_cols)
        yield [(c["id"], row * c["v"] + by, col * c["h"] + bx)
               for c in comps for by in range(c["v"]) for bx in range(c["h"])]


def _decode_progressive_scan(segments: List[bytes], comps: list, mcus: Tuple[int, int],
                             restart: int, spectral: Tuple[int, int, int, int],
                             coeffs: Dict[int, np.ndarray]) -> None:
    """Huffman-decode one scan of a progressive JPEG (jdphuff.c: DC first
    and refinement, AC first and refinement with end-of-band runs) into the
    quantised zigzag coefficients ``coeffs`` (component id -> (rows, cols,
    64) int32, updated in place)."""
    ss, se, ah, al = spectral
    p1, m1 = 1 << al, -1 << al
    blocks = list(_progressive_blocks(comps, mcus))
    tables = {c["id"]: c for c in comps}
    at, segment = 0, 0
    while at < len(blocks):
        if segment >= len(segments):
            raise ValueError("JPEG scan ends before its last MCU")
        window = _windows(segments[segment])
        segment += 1
        pos, eobrun = 0, 0
        predictions = {c["id"]: 0 for c in comps}
        stop = len(blocks) if not restart else min(len(blocks), at + restart)

        def bits(n):
            nonlocal pos
            value = window[pos] >> (16 - n) if n else 0
            pos += n
            return value

        def symbol(table):
            nonlocal pos
            sym, length = table
            w = window[pos]
            if length[w] == 0:
                raise ValueError("corrupt JPEG: no Huffman code matches")
            pos += length[w]
            return sym[w]

        for mcu in blocks[at:stop]:
            for cid, brow, bcol in mcu:
                block = coeffs[cid][brow, bcol]
                c = tables[cid]
                if ss == 0:                                     # DC scans
                    if ah == 0:
                        size = symbol(c["dc"])
                        if size > 15:
                            raise ValueError("corrupt JPEG: DC magnitude category over 15")
                        diff = _extend(bits(size), size) if size else 0
                        predictions[cid] += diff
                        block[0] = predictions[cid] * p1
                    elif bits(1):
                        block[0] |= p1
                    continue
                if ah == 0:                                     # AC first
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        sym = symbol(c["ac"])
                        run, size = sym >> 4, sym & 15
                        if size:
                            k += run
                            if k > 63:
                                raise ValueError("corrupt JPEG: coefficient past 63")
                            block[k] = _extend(bits(size), size) * p1
                        elif run == 15:
                            k += 15
                        else:
                            eobrun = (1 << run) + bits(run) - 1
                            break
                        k += 1
                    continue
                k = ss                                          # AC refinement
                if eobrun == 0:
                    while k <= se:
                        sym = symbol(c["ac"])
                        run, size = sym >> 4, sym & 15
                        value = 0
                        if size:
                            value = p1 if bits(1) else m1
                        elif run != 15:
                            eobrun = (1 << run) + bits(run)
                            break
                        while k <= se:
                            if block[k]:
                                if bits(1) and not block[k] & p1:
                                    block[k] += p1 if block[k] >= 0 else m1
                            else:
                                run -= 1
                                if run < 0:
                                    break
                            k += 1
                        if value and k <= se:
                            block[k] = value
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        if block[k] and bits(1) and not block[k] & p1:
                            block[k] += p1 if block[k] >= 0 else m1
                        k += 1
                    eobrun -= 1
        at = stop


def _decode_progressive_scan_native(segments: List[bytes], comps: list,
                                    mcus: Tuple[int, int], restart: int,
                                    spectral: Tuple[int, int, int, int],
                                    coeffs: Dict[int, np.ndarray]) -> None:
    """:func:`_decode_progressive_scan` in the native library."""
    import ctypes

    from hive_tpu_torch import native

    lib = native.get_native_lib()
    if lib is None:
        raise RuntimeError("the native library did not build; decode with native=False")
    offsets = np.cumsum([0] + [len(s) for s in segments]).astype(np.int64)
    data = np.frombuffer(b"".join(segments) or b"\0", np.uint8)
    h = np.array([c["h"] for c in comps], np.int32)
    v = np.array([c["v"] for c in comps], np.int32)
    outputs = [coeffs[c["id"]] for c in comps]
    if any(not (o.flags.c_contiguous and o.dtype == np.int32 and o.shape[0] >= mcus[0] * c["v"]
                and o.shape[1] >= mcus[1] * c["h"]) for o, c in zip(outputs, comps)):
        raise ValueError("JPEG coefficient arrays do not hold the scan's blocks")
    cols = np.array([o.shape[1] for o in outputs], np.int64)
    dc = np.stack([c["dc"] for c in comps])
    ac = np.stack([c["ac"] for c in comps])
    pointers = (ctypes.c_void_p * len(comps))(*(o.ctypes.data for o in outputs))

    def ptr(a, kind):
        return a.ctypes.data_as(ctypes.POINTER(kind))

    status = lib.hive_jpeg_decode_progressive_scan(
        ptr(data, ctypes.c_uint8), ptr(offsets, ctypes.c_int64), len(segments), len(comps),
        ptr(h, ctypes.c_int32), ptr(v, ctypes.c_int32), ptr(cols, ctypes.c_int64),
        ptr(dc, ctypes.c_uint8), ptr(ac, ctypes.c_uint8), mcus[0], mcus[1], restart,
        *spectral, pointers)
    if status:
        raise ValueError({-1: "corrupt JPEG: no Huffman code matches",
                          -3: "corrupt JPEG: coefficient past 63",
                          -4: "JPEG scan ends before its last MCU",
                          -5: "corrupt JPEG: DC magnitude category over 15"}[status])


def _scan_segments(blob: bytes, start: int) -> Tuple[List[bytes], int]:
    """Split the entropy-coded data from ``start`` at restart markers and
    remove byte stuffing; return the segments and the position of the
    marker that ends the scan."""
    data = np.frombuffer(blob, np.uint8)
    segments, begin = [], start
    for at in np.nonzero(data[start:-1] == 0xFF)[0] + start:
        follow = blob[at + 1]
        if follow in (0x00, 0xFF):                          # stuffing, fill
            continue
        segments.append(blob[begin:at].rstrip(b"\xff"))
        if 0xD0 <= follow <= 0xD7:                          # RSTn
            begin = at + 2
            continue
        return [s.replace(b"\xff\x00", b"\xff") for s in segments], int(at)
    raise ValueError("JPEG scan has no end marker")


def _islow_pass(x: np.ndarray, axis: int) -> np.ndarray:
    """One 8-point pass of libjpeg's integer "islow" IDCT along ``axis``,
    before its descale."""
    c = [np.take(x, k, axis=axis) for k in range(8)]
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * 4433                       # FIX_0_541196100
    tmp2 = z1 + z3 * -15137                     # FIX_1_847759065
    tmp3 = z1 + z2 * 6270                       # FIX_0_765366865
    tmp0 = (c[0] + c[4]) << _CONST_BITS
    tmp1 = (c[0] - c[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=axis)


# libjpeg's range limit after the IDCT (jdmaster.c): the value wrapped to 10
# bits, then clamped around the level shift of 128.
_RANGE_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                               np.arange(0, 128)]).astype(np.uint8)


def _wrap(x: np.ndarray, bits: int) -> np.ndarray:
    """``x`` as a signed ``bits``-bit C integer stores it (two's complement
    wrap)."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


# FFmpeg's "simple" IDCT (libavcodec/simple_idct_template.c, 8-bit): the
# cosines x sqrt(2) x 2^14, and the shifts of its row and column passes.
_W1, _W2, _W3, _W4, _W5, _W6, _W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
_ROW_SHIFT, _COL_SHIFT = 11, 20


def _simple_pass(c: List[np.ndarray], a0: np.ndarray) -> List[np.ndarray]:
    """One 8-point pass of FFmpeg's simple IDCT over coefficients ``c[0..7]``
    with the even part's rounding already in ``a0``; the eight sums before
    the shift, in output order."""
    a1, a2, a3 = a0 + _W6 * c[2], a0 - _W6 * c[2], a0 - _W2 * c[2]
    a0 = a0 + _W2 * c[2]
    b0 = _W1 * c[1] + _W3 * c[3] + _W5 * c[5] + _W7 * c[7]
    b1 = _W3 * c[1] - _W7 * c[3] - _W1 * c[5] - _W5 * c[7]
    b2 = _W5 * c[1] - _W1 * c[3] + _W7 * c[5] + _W3 * c[7]
    b3 = _W7 * c[1] - _W5 * c[3] + _W3 * c[5] - _W1 * c[7]
    a0 = a0 + _W4 * c[4] + _W6 * c[6]
    a1 = a1 - _W4 * c[4] - _W2 * c[6]
    a2 = a2 - _W4 * c[4] + _W2 * c[6]
    a3 = a3 + _W4 * c[4] - _W6 * c[6]
    return [_wrap(x, 32) for x in (a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2,
                                   a1 - b1, a0 - b0)]


def _simple_idct(blocks: np.ndarray) -> np.ndarray:
    """FFmpeg's ``ff_simple_idct_put_int16_8bit`` of (..., 8, 8) int16-valued
    coefficients (natural order, the level shift in the DC): the row pass
    with its DC-only shortcut, stored to int16, then the column pass,
    clipped to [0, 255]."""
    c = [blocks[..., k] for k in range(8)]
    rows = np.stack([x >> _ROW_SHIFT for x in _simple_pass(c, _W4 * c[0] + (1 << (_ROW_SHIFT - 1)))],
                    axis=-1)
    dc_only = ~np.any(blocks[..., 1:], axis=-1)
    rows = _wrap(np.where(dc_only[..., None], (c[0] * 8)[..., None], rows), 16)
    c = [rows[..., k, :] for k in range(8)]
    cols = _simple_pass(c, _W4 * (c[0] + (1 << (_COL_SHIFT - 1)) // _W4))
    return np.clip(np.stack([x >> _COL_SHIFT for x in cols], axis=-2), 0, 255).astype(np.uint8)


# The IDCTs a decode can take: libjpeg's islow (Pillow's pixels) and FFmpeg's
# simple IDCT (its MJPEG decoder's, so cv2.VideoCapture's pixels).
IDCTS = ("islow", "simple")


def _idct_planes(coeffs: np.ndarray, table: np.ndarray, idct: str = "islow") -> np.ndarray:
    """Dequantise and inverse-DCT (rows, cols, 64) zigzag blocks into one
    (8 rows, 8 cols) uint8 plane with libjpeg's islow IDCT, the one Pillow
    decodes with, or FFmpeg's simple IDCT (``idct="simple"``)."""
    natural = np.zeros(coeffs.shape, np.int64)
    natural[..., ZIGZAG] = coeffs * table[ZIGZAG]
    blocks = natural.reshape(*coeffs.shape[:2], 8, 8)
    if idct == "simple":
        # FFmpeg's decoder keeps each block in int16 (the DC clipped, the AC
        # wrapped) and starts its DC predictor at 1024: the level shift.
        blocks = _wrap(blocks, 16)
        blocks[..., 0, 0] = np.clip(natural[..., 0] + 1024, -32768, 32767)
        pixels = _simple_idct(blocks)
    else:
        work = _descale(_islow_pass(blocks, axis=-2), _CONST_BITS - _PASS1_BITS)
        pixels = _RANGE_LIMIT[_descale(_islow_pass(work, axis=-1),
                                       _CONST_BITS + _PASS1_BITS + 3) & 1023]
    rows, cols = coeffs.shape[:2]
    return pixels.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def _fancy_upsample(plane: np.ndarray, vertical: bool) -> np.ndarray:
    """libjpeg's triangle-filter 2x upsampling (jdsample.c h2v1 / h2v2) of an
    int32 plane."""
    if vertical:
        up = np.concatenate([plane[:1], plane[:-1]])
        down = np.concatenate([plane[1:], plane[-1:]])
        sums = np.empty((plane.shape[0] * 2, plane.shape[1]), np.int32)
        triple = 3 * plane
        np.add(triple, up, out=sums[0::2])
        np.add(triple, down, out=sums[1::2])
        even_bias, odd_bias = 8, 7
        shift = 4
    else:
        sums = plane
        even_bias, odd_bias = 1, 2
        shift = 2
    left = np.concatenate([sums[:, :1], sums[:, :-1]], axis=1)
    right = np.concatenate([sums[:, 1:], sums[:, -1:]], axis=1)
    out = np.empty((sums.shape[0], sums.shape[1] * 2), np.int32)
    triple = 3 * sums
    out[:, 0::2] = (triple + left + even_bias) >> shift
    out[:, 1::2] = (triple + right + odd_bias) >> shift
    return out


def _colour_tables():
    """libjpeg's YCbCr -> RGB tables (jdcolor.c build_ycc_rgb_table), indexed
    by Cb or Cr, and its clamp to [0, 255], indexed by value + 512."""
    half = 1 << 15

    def fix(x):
        return int(x * 65536 + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    clamp = np.clip(np.arange(1024) - 512, 0, 255).astype(np.uint8)
    return cr_r, cb_b, cr_g, cb_g, clamp


_CR_R, _CB_B, _CR_G, _CB_G, _CLAMP = _colour_tables()


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's fixed-point JFIF conversion (jdcolor.c)."""
    y = y + 512
    rgb = np.empty((*y.shape, 3), np.uint8)
    rgb[..., 0] = _CLAMP[y + _CR_R[cr]]
    rgb[..., 1] = _CLAMP[y + ((_CB_G[cb] + _CR_G[cr]) >> 16)]
    rgb[..., 2] = _CLAMP[y + _CB_B[cb]]
    return rgb


def _decode_scan_native(segments: List[bytes], comps: list, mcus: Tuple[int, int],
                        restart: int, planes: Dict[int, np.ndarray], idct: str) -> None:
    """:func:`_decode_scan` and :func:`_idct_planes` in the native library:
    decode the scan's blocks straight into ``planes`` (component id ->
    (rows * 8, cols * 8) uint8, filled in place) with the ``idct`` named."""
    import ctypes

    from hive_tpu_torch import native

    lib = native.get_native_lib()
    if lib is None:
        raise RuntimeError("the native library did not build; decode with native=False")
    offsets = np.cumsum([0] + [len(s) for s in segments]).astype(np.int64)
    data = np.frombuffer(b"".join(segments) or b"\0", np.uint8)
    h = np.array([c["h"] for c in comps], np.int32)
    v = np.array([c["v"] for c in comps], np.int32)
    outputs = [planes[c["id"]] for c in comps]
    if any(not (p.flags.c_contiguous and p.dtype == np.uint8 and p.shape[0] % 8 == 0
                and p.shape[1] % 8 == 0 and p.shape[0] // 8 >= mcus[0] * c["v"]
                and p.shape[1] // 8 >= mcus[1] * c["h"]) for p, c in zip(outputs, comps)):
        raise ValueError("JPEG planes do not hold the scan's blocks")
    cols = np.array([p.shape[1] // 8 for p in outputs], np.int64)
    dc = np.stack([c["dc"] for c in comps])
    ac = np.stack([c["ac"] for c in comps])
    quant = np.stack([c["quant"] for c in comps]).astype(np.int32)
    pointers = (ctypes.c_void_p * len(comps))(*(p.ctypes.data for p in outputs))

    def ptr(a, kind):
        return a.ctypes.data_as(ctypes.POINTER(kind))

    status = lib.hive_jpeg_decode_scan(
        ptr(data, ctypes.c_uint8), ptr(offsets, ctypes.c_int64), len(segments), len(comps),
        ptr(h, ctypes.c_int32), ptr(v, ctypes.c_int32), ptr(cols, ctypes.c_int64),
        ptr(dc, ctypes.c_uint8), ptr(ac, ctypes.c_uint8), ptr(quant, ctypes.c_int32),
        mcus[0], mcus[1], restart, IDCTS.index(idct), pointers)
    if status:
        raise ValueError({-1: "corrupt JPEG: no DC code matches",
                          -2: "corrupt JPEG: no AC code matches",
                          -3: "corrupt JPEG: coefficient past 63",
                          -4: "JPEG scan ends before its last MCU",
                          -5: "corrupt JPEG: DC magnitude category over 15"}[status])


def _huffman_spec(counts: List[int], symbols: List[int]) -> np.ndarray:
    """16 code counts, then the symbols padded to 256: the native layout."""
    spec = np.zeros(16 + 256, np.uint8)
    spec[:16] = counts
    spec[16:16 + len(symbols)] = symbols
    return spec


@dataclass
class JpegPlanes:
    """A JPEG's decoded components before upsampling: ``planes[i]`` is
    component ``i`` (SOF order) as uint8, cropped to its own size, and
    ``sampling[i]`` its (horizontal, vertical) sampling factors."""

    width: int
    height: int
    sampling: List[Tuple[int, int]]
    planes: List[np.ndarray]


def decode_jpeg_planes(blob: bytes, native: Optional[bool] = None,
                       idct: str = "islow") -> JpegPlanes:
    """Decode a baseline, extended sequential or progressive Huffman JPEG's
    scans into its component planes, with libjpeg's islow IDCT or FFmpeg's
    simple IDCT (``idct="simple"``). Huffman tables a file does not define
    are the standard ones of Annex K (tables 0 and 1), as libjpeg-turbo and
    FFmpeg both assume for Motion JPEG.

    :param native: decode the scans in the native library (True) or with
        the Python symbol loop and numpy (False); by default native when the
        library builds.
    """
    if blob[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    if idct not in IDCTS:
        raise ValueError(f"idct must be one of {IDCTS}, not {idct!r}")
    if native is None:
        from hive_tpu_torch import native as native_lib

        native = native_lib.get_native_lib() is not None

    quant: Dict[int, np.ndarray] = {}
    huffman: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = {
        (0, 0): _DC_LUMA, (0, 1): _DC_CHROMA, (1, 0): _AC_LUMA, (1, 1): _AC_CHROMA}
    frame = None
    planes: Dict[int, np.ndarray] = {}
    # A progressive frame's quantised coefficients, and each component's
    # quantisation table as latched at its first scan.
    coeffs: Dict[int, np.ndarray] = {}
    latched: Dict[int, np.ndarray] = {}
    restart = 0
    pos = 2
    while pos < len(blob):
        if blob[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: expected a marker at byte {pos}")
        marker = blob[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:                                  # EOI
            break
        (length,) = struct.unpack(">H", blob[pos + 2:pos + 4])
        body = blob[pos + 4:pos + 2 + length]
        pos += 2 + length

        if marker == 0xDB:                                  # DQT
            at = 0
            while at < len(body):
                precision, table_id = body[at] >> 4, body[at] & 15
                count = 128 if precision else 64
                values = np.frombuffer(body[at + 1:at + 1 + count],
                                       ">u2" if precision else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = values
                quant[table_id] = table
                at += 1 + count
        elif marker == 0xC4:                                # DHT
            at = 0
            while at < len(body):
                table_class, table_id = body[at] >> 4, body[at] & 15
                counts = list(body[at + 1:at + 17])
                symbols = list(body[at + 17:at + 17 + sum(counts)])
                huffman[table_class, table_id] = (counts, symbols)
                at += 17 + sum(counts)
        elif marker in (0xC0, 0xC1, 0xC2):                  # SOF0 / SOF1 / SOF2
            precision, height, width, count = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"{precision}-bit JPEG samples are not supported")
            if count not in (1, 3):
                raise NotImplementedError(f"JPEG with {count} components is not supported")
            comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4,
                          v=body[7 + 3 * i] & 15, q=body[8 + 3 * i]) for i in range(count)]
            frame = dict(height=height, width=width, comps=comps, progressive=marker == 0xC2)
            if frame["progressive"]:
                h_max = max(c["h"] for c in comps)
                v_max = max(c["v"] for c in comps)
                for c in comps:
                    coeffs[c["id"]] = np.zeros(
                        (-(-height // (8 * v_max)) * c["v"], -(-width // (8 * h_max)) * c["h"],
                         64), np.int32)
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise NotImplementedError(f"JPEG frame type 0x{marker:02X} (lossless, hierarchical "
                                      f"or arithmetic) is not supported")
        elif marker == 0xDD:                                # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:                                # SOS
            if frame is None:
                raise ValueError("corrupt JPEG: scan before frame header")
            h_max = max(c["h"] for c in frame["comps"])
            v_max = max(c["v"] for c in frame["comps"])
            mcu_rows = -(-frame["height"] // (8 * v_max))
            mcu_cols = -(-frame["width"] // (8 * h_max))
            by_id = {c["id"]: c for c in frame["comps"]}
            scan = []
            count = body[0]
            spectral = (body[1 + 2 * count], body[2 + 2 * count],
                        body[3 + 2 * count] >> 4, body[3 + 2 * count] & 15)
            for i in range(count):
                c = dict(by_id[body[1 + 2 * i]])
                dc = huffman.get((0, body[2 + 2 * i] >> 4))
                ac = huffman.get((1, body[2 + 2 * i] & 15))
                if native:
                    c["dc"], c["ac"] = (_huffman_spec(*t) if t else _huffman_spec([0] * 16, [])
                                        for t in (dc, ac))
                    c["quant"] = quant[c["q"]]
                else:
                    c["dc"], c["ac"] = (_lookup_table(*t) if t else _lookup_table([0] * 16, [])
                                        for t in (dc, ac))
                scan.append(c)
            if len(scan) == 1:
                # One component is coded block by block, not in MCUs.
                c = scan[0]
                mcus = (-(-frame["height"] * c["v"] // (8 * v_max)),
                        -(-frame["width"] * c["h"] // (8 * h_max)))
                c["h"] = c["v"] = 1
            else:
                mcus = (mcu_rows, mcu_cols)
            segments, pos = _scan_segments(blob, pos)
            if frame["progressive"]:
                for c in scan:
                    latched.setdefault(c["id"], quant[c["q"]])
                decode = _decode_progressive_scan_native if native else _decode_progressive_scan
                decode(segments, scan, mcus, restart, spectral, coeffs)
            elif native:
                for c in scan:
                    planes[c["id"]] = np.zeros((mcus[0] * c["v"] * 8, mcus[1] * c["h"] * 8),
                                               np.uint8)
                _decode_scan_native(segments, scan, mcus, restart, planes, idct)
            else:
                scan_coeffs = {c["id"]: np.zeros((mcus[0] * c["v"], mcus[1] * c["h"], 64),
                                                 np.int64) for c in scan}
                _decode_scan(segments, scan, mcus, restart, scan_coeffs)
                for c in scan:
                    planes[c["id"]] = _idct_planes(scan_coeffs[c["id"]], quant[c["q"]], idct)

    if frame is not None and frame["progressive"] and latched:
        for c in frame["comps"]:
            planes[c["id"]] = _idct_planes(coeffs[c["id"]],
                                           latched.get(c["id"], quant.get(c["q"])), idct)

    if frame is None or not planes:
        raise ValueError("corrupt JPEG: no frame or no scan")

    height, width = frame["height"], frame["width"]
    h_max = max(c["h"] for c in frame["comps"])
    v_max = max(c["v"] for c in frame["comps"])
    return JpegPlanes(width, height, [(c["h"], c["v"]) for c in frame["comps"]],
                      [planes[c["id"]][:-(-height * c["v"] // v_max),
                                       :-(-width * c["h"] // h_max)] for c in frame["comps"]])


def decode_jpeg(blob: bytes, native: Optional[bool] = None) -> np.ndarray:
    """Decode a baseline, extended sequential or progressive Huffman JPEG to
    the pixels libjpeg's default decode gives (islow IDCT, fancy upsampling),
    which are Pillow's.

    :param native: as for :func:`decode_jpeg_planes`.
    :return: (H, W, 3) uint8 RGB for a three-component file, (H, W) uint8
        for a greyscale one.
    """
    decoded = decode_jpeg_planes(blob, native)
    height, width = decoded.height, decoded.width
    h_max = max(h for h, _ in decoded.sampling)
    v_max = max(v for _, v in decoded.sampling)
    out = []
    for (h, v), plane in zip(decoded.sampling, decoded.planes):
        # Each plane is cropped to the component's own size: upsampling
        # repeats its last row and column, not the blocks' padding.
        plane = plane.astype(np.int32)
        fy, fx = v_max // v, h_max // h
        if (fy, fx) == (2, 2):
            plane = _fancy_upsample(plane, vertical=True)
        elif (fy, fx) == (1, 2):
            plane = _fancy_upsample(plane, vertical=False)
        elif (fy, fx) != (1, 1):
            plane = np.repeat(np.repeat(plane, fy, axis=0), fx, axis=1)
        out.append(plane[:height, :width])

    if len(out) == 1:
        return out[0].astype(np.uint8)
    return _ycbcr_to_rgb(*out)


# ---------------------------------------------------------------------------
# Files.
# ---------------------------------------------------------------------------

# The JPEG quality of hive_tpu's frame writers: imageio's Pillow plugin
# (Pillow's default) for converted frames; cv2.imwrite for inpainted ones.
PILLOW_JPEG_QUALITY = 75
CV2_JPEG_QUALITY = 95


def write_image(path: str, image: np.ndarray, jpeg_quality: int = PILLOW_JPEG_QUALITY):
    """Write a frame as ``hive_tpu``'s ``imageio.imwrite`` or ``cv2.imwrite``
    does, picked by the extension: JPEG (4:2:0) at ``jpeg_quality``,
    otherwise PNG."""
    if Path(path).suffix.lower() in (".jpg", ".jpeg"):
        blob = encode_jpeg(image, quality=jpeg_quality)
    else:
        blob = encode_png(image)
    with open(path, "wb") as f:
        f.write(blob)
