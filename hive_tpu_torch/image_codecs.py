"""PNG and JPEG codecs in numpy and zlib, where the JAX package uses Pillow.

The card's machine has no Pillow, OpenCV or imageio, so the port encodes the
textures of its glTF files and its 16-bit depth PNGs itself:

* :func:`encode_png`: 8-bit grey, grey+alpha, RGB and RGBA, and 16-bit grey;
  non-interlaced, one filter per row picked by the smallest sum of absolute
  filtered bytes (libpng's heuristic), zlib level 6. Lossless; the decoder
  is ``hive_tpu_torch.io.decode_png``.
* :func:`encode_jpeg`: baseline sequential JFIF, YCbCr 4:2:0, the IJG
  quality-scaled quantisation tables and the standard Huffman tables of the
  JPEG specification (Annex K): what Pillow writes for
  ``save(format="JPEG", quality=q)``. The DCT is computed in float64, so the
  bytes differ from libjpeg's integer DCT, not the format.
* :func:`decode_jpeg`: baseline and extended sequential Huffman JPEGs with one
  or three components, any sampling factors of 1 or 2, restart intervals;
  libjpeg's fancy chroma upsampling and fixed-point YCbCr -> RGB, a float
  inverse DCT.

Entropy coding is vectorised: every Huffman code and its extra bits become
one token, the tokens are sorted into scan order and expanded into bits with
numpy. Decoding is a Python loop over symbols with a 16-bit lookup table.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

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


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    m = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


_DCT = _dct_matrix()


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


def _forward_dct_quantised(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Level-shifted float DCT of each 8x8 block, quantised with rounding
    half away from zero (libjpeg's quantiser); (H/8, W/8, 64) in zigzag."""
    coeffs = _DCT @ (_blocks(plane).astype(np.float64) - 128.0) @ _DCT.T
    q = table.reshape(8, 8)
    quantised = np.sign(coeffs) * np.floor(np.abs(coeffs) / q + 0.5)
    flat = quantised.reshape(*quantised.shape[:2], 64).astype(np.int64)
    return flat[..., ZIGZAG]


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

    # Pad to whole 16x16 MCUs by repeating the last row and column.
    padded = np.pad(image, ((0, (-height) % 16), (0, (-width) % 16), (0, 0)), mode="edge")
    ycc = _rgb_to_ycbcr(padded)
    luma_table, chroma_table = quality_tables(quality)

    # 2x2 chroma averaging with libjpeg's alternating 1, 2 rounding bias.
    h2, w2 = padded.shape[0] // 2, padded.shape[1] // 2
    bias = np.tile([1, 2], w2 // 2 + 1)[:w2]
    chroma = [(ycc[..., c].reshape(h2, 2, w2, 2).sum(axis=(1, 3)) + bias) >> 2
              for c in (1, 2)]

    y_blocks = _forward_dct_quantised(ycc[..., 0], luma_table)      # (2M, 2N, 64)
    cb_blocks, cr_blocks = (_forward_dct_quantised(c, chroma_table) for c in chroma)
    my, mx = cb_blocks.shape[:2]

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
    dqt = segment(0xDB, b"\x00" + bytes(luma_table[ZIGZAG].tolist())
                  + b"\x01" + bytes(chroma_table[ZIGZAG].tolist()))
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


def _idct_planes(coeffs: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Dequantise and inverse-DCT (rows, cols, 64) zigzag blocks into one
    (8 rows, 8 cols) uint8 plane."""
    natural = np.zeros(coeffs.shape, np.float64)
    natural[..., ZIGZAG] = coeffs * table[ZIGZAG]
    blocks = natural.reshape(*coeffs.shape[:2], 8, 8)
    pixels = _DCT.T @ blocks @ _DCT + 128.0
    rows, cols = coeffs.shape[:2]
    plane = pixels.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
    return np.clip(np.round(plane), 0, 255).astype(np.int64)


def _fancy_upsample(plane: np.ndarray, vertical: bool) -> np.ndarray:
    """libjpeg's triangle-filter 2x upsampling (jdsample.c h2v1 / h2v2)."""
    if vertical:
        up = np.concatenate([plane[:1], plane[:-1]])
        down = np.concatenate([plane[1:], plane[-1:]])
        sums = np.empty((plane.shape[0] * 2, plane.shape[1]), np.int64)
        sums[0::2] = 3 * plane + up
        sums[1::2] = 3 * plane + down
        even_bias, odd_bias = 8, 7
        shift = 4
    else:
        sums = plane
        even_bias, odd_bias = 1, 2
        shift = 2
    left = np.concatenate([sums[:, :1], sums[:, :-1]], axis=1)
    right = np.concatenate([sums[:, 1:], sums[:, -1:]], axis=1)
    out = np.empty((sums.shape[0], sums.shape[1] * 2), np.int64)
    out[:, 0::2] = (3 * sums + left + even_bias) >> shift
    out[:, 1::2] = (3 * sums + right + odd_bias) >> shift
    return out


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's fixed-point JFIF conversion (jdcolor.c)."""
    half = 1 << 15

    def fix(x):
        return int(x * 65536 + 0.5)

    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb - fix(0.71414) * cr + half) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(blob: bytes) -> np.ndarray:
    """Decode a baseline (or extended sequential Huffman) JPEG.

    :return: (H, W, 3) uint8 RGB for a three-component file, (H, W) uint8
        for a greyscale one.
    """
    if blob[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")

    quant: Dict[int, np.ndarray] = {}
    huffman: Dict[Tuple[int, int], Tuple[list, list]] = {}
    frame = None
    coeffs: Dict[int, np.ndarray] = {}
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
                huffman[table_class, table_id] = _lookup_table(counts, symbols)
                at += 17 + sum(counts)
        elif marker in (0xC0, 0xC1):                        # SOF0 / SOF1
            precision, height, width, count = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"{precision}-bit JPEG samples are not supported")
            if count not in (1, 3):
                raise NotImplementedError(f"JPEG with {count} components is not supported")
            comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4,
                          v=body[7 + 3 * i] & 15, q=body[8 + 3 * i]) for i in range(count)]
            frame = dict(height=height, width=width, comps=comps)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise NotImplementedError(f"JPEG frame type 0x{marker:02X} (progressive, lossless "
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
            for i in range(body[0]):
                c = dict(by_id[body[1 + 2 * i]])
                c["dc"] = huffman[0, body[2 + 2 * i] >> 4]
                c["ac"] = huffman[1, body[2 + 2 * i] & 15]
                scan.append(c)
                coeffs.setdefault(c["id"], np.zeros(
                    (mcu_rows * c["v"], mcu_cols * c["h"], 64), np.int64))
            if len(scan) != len(frame["comps"]):
                raise NotImplementedError("non-interleaved JPEG scans are not supported")
            if len(scan) == 1:
                # One component is coded block by block, not in MCUs.
                c = scan[0]
                c["h"] = c["v"] = 1
                rows = -(-frame["height"] * by_id[c["id"]]["v"] // (8 * v_max))
                cols = -(-frame["width"] * by_id[c["id"]]["h"] // (8 * h_max))
                coeffs[c["id"]] = np.zeros((rows, cols, 64), np.int64)
                mcus = (rows, cols)
            else:
                mcus = (mcu_rows, mcu_cols)
            segments, pos = _scan_segments(blob, pos)
            _decode_scan(segments, scan, mcus, restart, coeffs)

    if frame is None or not coeffs:
        raise ValueError("corrupt JPEG: no frame or no scan")

    height, width = frame["height"], frame["width"]
    h_max = max(c["h"] for c in frame["comps"])
    v_max = max(c["v"] for c in frame["comps"])
    planes = []
    for c in frame["comps"]:
        # Crop to the component's own size first: upsampling repeats its
        # last row and column, not the blocks' padding.
        plane = _idct_planes(coeffs[c["id"]], quant[c["q"]])[
            :-(-height * c["v"] // v_max), :-(-width * c["h"] // h_max)]
        fy, fx = v_max // c["v"], h_max // c["h"]
        if (fy, fx) == (2, 2):
            plane = _fancy_upsample(plane, vertical=True)
        elif (fy, fx) == (1, 2):
            plane = _fancy_upsample(plane, vertical=False)
        elif (fy, fx) != (1, 1):
            plane = np.repeat(np.repeat(plane, fy, axis=0), fx, axis=1)
        planes.append(plane[:height, :width])

    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    return _ycbcr_to_rgb(*planes)
