"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video, both ways, as
FFmpeg's ``mpeg4`` decoder, and so ``cv2.VideoCapture``, reads it.

It is what cv2's default ``mp4v`` writer stores in an ``.mp4`` (also for
the ``XVID``, ``DIVX`` and ``FMP4`` fourccs, which its MP4 muxer maps to
``mp4v``): an ``esds`` of objectTypeIndication 0x20 whose
DecoderSpecificInfo holds the VOS, VO and VOL headers and the encoder's
user data, then one VOP a sample, I-VOPs after a GOV header.

**The reader** (:class:`Mpeg4Decoder`) parses the VOS, VO, VOL, user data,
GOV and VOP headers here, from the track's config or in-band, and decodes
each VOP's macroblocks in one native call (``native/src/mpeg4_decode.cpp``:
the macroblock layer, DC / AC prediction, H.263 inverse quantisation,
FFmpeg's simple IDCT, half-pel motion compensation, video packets), holding
the reference picture between calls. A VOP with ``vop_coded`` 0 (an N-VOP)
gives no picture, as FFmpeg gives no frame for it. There is no numpy
decoder beside the native one: without a C++ toolchain it raises, naming
the failed build. Checked against cv2 5.0.0 (FFmpeg's libavcodec 62), bit
for bit, on cv2's own writer's files and on this module's:

* reference pictures end at the coded size (16-pixel macroblocks) for 1MV
  motion compensation, which replicates them past it (``h_edge_pos`` /
  ``v_edge_pos``); a 4MV block's source is first clamped to [-16, width]
  x [-16, height] of the picture's display size, as ``hpel_motion`` does;
* the 8-wide no-rounding half-pel averages (``vop_rounding_type`` 1: 4MV
  blocks and chroma) are the inexact x86 ones FFmpeg builds use unless
  asked to be bit-exact (``pavgb`` of the left sample, or of the odd row's,
  less one, saturated); the 16-wide ones are exact.

Refused by name before any picture is decoded, naming ROADMAP Queue 1 item
9d (:class:`~hive_tpu_torch.video.mp4.UnsupportedVideoError`): B-VOPs (and
VOLs whose ``low_delay`` is 0), S-VOPs, sprites and GMC, interlaced VOLs,
quarter-pel, MPEG quantisation matrices (``quant_type`` 1), data
partitioning and reversible VLCs, shapes other than rectangular, depths
other than 8 bits, scalability, NEWPRED, reduced-resolution VOPs,
complexity estimation headers, chroma other than 4:2:0, odd sizes, a VO's
video signal type (range or colour description), studio profiles,
``short_video_header`` (H.263 baseline) streams, and the user data for
which FFmpeg switches IDCT or turns on bug workarounds
(``ff_mpeg4_workaround_bugs``): Xvid builds, DivX, and libavcodec builds
before 4713 or in the interlaced-edge range.

**The writer** (:func:`write_mpeg4_mp4`) makes such files from uint8 4:2:0
planes, for the tests and ``chip_smoke.py``: I-VOPs every ``gop`` frames
after a GOV header, P-VOPs between with the caller's half-pel motion
field, 1MV or 4MV, forced intra and ``not_coded`` macroblocks, a
quantiser per macroblock (DQUANT), AC prediction on, off or where it saves
bits, resync markers every N macroblocks, N-VOP samples and user data; the
rounding type alternates as FFmpeg's encoder alternates it (1 on the first
P-VOP after an I-VOP). It reconstructs each reference picture with the
reader's own native decoder, so nothing drifts.
"""

from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from hive_tpu_torch.video import mp4
from hive_tpu_torch.video.mp4 import OTHER_CODEC_ITEM, UnsupportedVideoError

VOS_START, USER_DATA, GOV_START, VO_START, VOP_START = 0x1B0, 0x1B2, 0x1B3, 0x1B5, 0x1B6
SIMPLE_VO_TYPE, ADV_SIMPLE_VO_TYPE = 1, 17
I_VOP, P_VOP, B_VOP, S_VOP = 0, 1, 2, 3
# vop intra_dc_vlc_thr -> the qscale from which the DC goes through the AC VLCs.
DC_THRESHOLDS = (99, 13, 15, 17, 19, 21, 23, 0)


def _refuse(what: str) -> UnsupportedVideoError:
    return UnsupportedVideoError(
        f"The MPEG-4 Part 2 video uses {what}; hive_tpu_torch decodes only the Simple "
        f"Profile subset that FFmpeg's mpeg4 decoder reads without workarounds (ROADMAP.md "
        f"{OTHER_CODEC_ITEM}).")


class _Bits:
    """MSB-first reader; past the end it reads zeros, as FFmpeg does."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos
        self.size = 8 * len(data)

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        first, last = self.pos >> 3, (self.pos + n + 7) >> 3
        word = int.from_bytes(self.data[first:last].ljust(last - first, b"\0"), "big")
        value = (word >> ((last << 3) - self.pos - n)) & ((1 << n) - 1)
        self.pos += n
        return value

    def marker(self) -> None:
        self.u(1)                  # FFmpeg only warns on a missing marker bit


def start_codes(data: bytes) -> List[Tuple[int, int]]:
    """(start code value 0x100-0x1FF, byte offset after it) of each
    ``00 00 01 xx`` in ``data``."""
    return [(0x100 | data[m.start() + 3], m.start() + 4)
            for m in re.finditer(b"\x00\x00\x01", data) if m.start() + 3 < len(data)]


def av_log2(v: int) -> int:
    return max(v, 1).bit_length() - 1


@dataclass
class StreamHeaders:
    """What the VO, VOL and user data headers say, as far as decoding needs
    it, and the encoder builds FFmpeg reads from the user data (-1: none)."""

    width: int = 0
    height: int = 0
    time_increment_bits: int = 0
    have_vol: bool = False
    resync_markers: bool = False   # the VOL's resync_marker_disable is 0
    xvid_build: int = -1
    divx_version: int = -1
    lavc_build: int = -1
    user_data: List[bytes] = field(default_factory=list)

    def parse(self, data: bytes) -> Optional[int]:
        """Read the headers in ``data`` up to its first VOP; the bit where
        that VOP's header starts, if it has one."""
        codes = start_codes(data)
        if not codes and _Bits(data).u(22) == 0x20:
            raise _refuse("short_video_header (H.263 baseline pictures)")
        for k, (code, pos) in enumerate(codes):
            end = codes[k + 1][1] - 4 if k + 1 < len(codes) else len(data)
            if code == VOS_START:
                profile = data[pos] if pos < len(data) else 0
                if 0xE1 <= profile <= 0xE8:
                    raise _refuse(f"a studio profile (profile_and_level_indication "
                                  f"0x{profile:02X})")
            elif code == VO_START:
                self._visual_object(_Bits(data[pos:end]))
            elif 0x120 <= code <= 0x12F:
                self._vol(_Bits(data[pos:end]))
            elif code == USER_DATA:
                self._user_data(data[pos:end])
            elif code == VOP_START:
                return 8 * pos
        return None

    def _visual_object(self, r: _Bits) -> None:
        if r.u(1):
            r.u(4 + 3)                                  # verid, priority
        visual_type = r.u(4)
        if visual_type in (1, 2) and r.u(1):            # video_signal_type
            r.u(3)                                      # video_format
            full_range = r.u(1)
            described = r.u(1)
            if full_range or described:
                raise _refuse("a visual object video signal type (full range or a colour "
                              "description), which FFmpeg's conversion path would read")

    def _vol(self, r: _Bits) -> None:
        r.u(1)                                          # random_accessible_vol
        vo_type = r.u(8)
        verid = 1
        if r.u(1):                                      # is_object_layer_identifier
            verid = r.u(4)
            r.u(3)
        if r.u(4) == 15:                                # aspect_ratio_info: extended PAR
            r.u(16)
        if r.u(1):                                      # vol_control_parameters
            chroma = r.u(2)
            if chroma != 1:
                raise _refuse(f"chroma_format {chroma} (not 4:2:0)")
            low_delay = r.u(1)
            if r.u(1):                                  # vbv_parameters
                r.u(15), r.marker(), r.u(15), r.marker(), r.u(15), r.marker()
                r.u(3), r.u(11), r.marker(), r.u(15), r.marker()
        else:
            # FFmpeg's default, and its forced low_delay for DivX 4 / old
            # Xvid (object type 0).
            low_delay = vo_type in (SIMPLE_VO_TYPE, ADV_SIMPLE_VO_TYPE) or (
                vo_type == 0 and self.divx_version == -1)
        shape = r.u(2)
        if shape != 0:
            raise _refuse(f"video_object_layer_shape {shape} (not rectangular)")
        r.marker()
        resolution = r.u(16)
        if not resolution:
            raise ValueError("corrupt MPEG-4 VOL: vop_time_increment_resolution 0")
        self.time_increment_bits = max(av_log2(resolution - 1) + 1, 1)
        r.marker()
        if r.u(1):                                      # fixed_vop_rate
            r.u(self.time_increment_bits)
        r.marker()
        width = r.u(13)
        r.marker()
        height = r.u(13)
        r.marker()
        if r.u(1):
            raise _refuse("an interlaced VOL")
        r.u(1)                                          # obmc_disable (FFmpeg ignores it)
        sprite = r.u(1 if verid == 1 else 2)
        if sprite:
            raise _refuse(f"sprites (sprite_enable {sprite}: static sprites or GMC)")
        if r.u(1):
            raise _refuse("not_8_bit (a depth or quantiser precision other than 8 / 5 bits)")
        if r.u(1):
            raise _refuse("quant_type 1 (MPEG quantisation matrices)")
        if verid != 1 and r.u(1):
            raise _refuse("quarter-pel motion (quarter_sample)")
        if not r.u(1):
            raise _refuse("a complexity estimation header")
        self.resync_markers = not r.u(1)                # resync_marker_disable
        if r.u(1):
            raise _refuse("data partitioning" + (" with reversible VLCs" if r.u(1) else ""))
        if verid != 1:
            if r.u(1):
                raise _refuse("NEWPRED")
            if r.u(1):
                raise _refuse("reduced-resolution VOPs")
        if r.u(1):
            raise _refuse("scalability")
        if width % 2 or height % 2:
            raise _refuse(f"an odd picture size ({width}x{height})")
        if not low_delay:
            raise _refuse("B-VOPs (the VOL's low_delay is 0)")
        self.width, self.height, self.have_vol = width, height, True

    def _user_data(self, data: bytes) -> None:
        """decode_user_data: the encoder builds FFmpeg reads from the first
        255 bytes, up to a zero; then ff_mpeg4_workaround_bugs's refusals."""
        data = data[:255].split(b"\0")[0]
        self.user_data.append(data)
        text = data.decode("latin-1")
        m = re.match(r"DivX(-?\d+)(?:Build|b)(-?\d+)", text)
        if m:
            self.divx_version = int(m[1])
        build = None
        m = re.match(r"FFmpe[^b]*b(-?\d+)", text) or re.match(
            r"FFmpeg v-?\d+\.-?\d+\.-?\d+ / libavcodec build: (-?\d+)", text)
        if m:
            build = int(m[1])
        else:
            m = re.match(r"Lavc(-?\d+)\.(-?\d+)\.(-?\d+)", text)
            if m:
                build = ((int(m[1]) & 0xFF) << 16) + ((int(m[2]) & 0xFF) << 8) + (int(m[3]) & 0xFF)
            elif text == "ffmpeg":
                build = 4600
        if build is not None:
            self.lavc_build = build
        m = re.match(r"XviD(-?\d+)", text)
        if m:
            self.xvid_build = int(m[1])
        self.check_workarounds()

    def check_workarounds(self) -> None:
        said = b", ".join(self.user_data).decode("latin-1")
        if self.xvid_build >= 0:
            raise _refuse(f"Xvid user data ('{said}'): FFmpeg decodes Xvid streams with the "
                          f"Xvid IDCT and its bug workarounds")
        if self.divx_version >= 0:
            raise _refuse(f"DivX user data ('{said}'): FFmpeg turns on DivX bug workarounds")
        b = self.lavc_build
        if b >= 0 and (b < 4713 or (b & 0xFF) >= 100 and 3621476 < b < 3752552
                       and not 3752037 <= b <= 3752191):
            raise _refuse(f"user data of a libavcodec build ({b}, '{said}') for which FFmpeg "
                          f"turns on bug workarounds")


@dataclass
class VopHeader:
    coding_type: int
    coded: bool
    rounding: int = 0
    qscale: int = 0
    fcode: int = 1
    intra_dc_threshold: int = 99
    bit_pos: int = 0               # the first bit of the macroblock layer


def parse_vop_header(data: bytes, pos: int, headers: StreamHeaders) -> VopHeader:
    """decode_vop_header for a rectangular Simple Profile VOL."""
    r = _Bits(data, pos)
    coding_type = r.u(2)
    if coding_type == B_VOP:
        raise _refuse("B-VOPs")
    if coding_type == S_VOP:
        raise _refuse("S-VOPs (sprites / GMC)")
    while r.u(1):                                       # modulo_time_base
        if r.pos > r.size:
            raise ValueError("corrupt MPEG-4 VOP header")
    r.marker()
    r.u(headers.time_increment_bits)
    r.marker()
    if not r.u(1):
        return VopHeader(coding_type, False)
    rounding = r.u(1) if coding_type == P_VOP else 0
    threshold = DC_THRESHOLDS[r.u(3)]
    qscale = r.u(5)
    if not qscale:
        raise ValueError("corrupt MPEG-4 VOP header: vop_quant 0")
    fcode = 1
    if coding_type == P_VOP:
        fcode = r.u(3)
        if not fcode:
            raise ValueError("corrupt MPEG-4 VOP header: vop_fcode_forward 0")
    return VopHeader(coding_type, True, rounding, qscale, fcode, threshold, r.pos)


_STATUS = {-1: "an MCBPC code that matches none", -2: "a CBPY code that matches none",
           -3: "a motion vector code that matches none", -4: "an intra DC size over 9",
           -5: "damaged AC coefficients", -6: "a third escape without its marker bits",
           -7: "a resync marker or video packet header out of place",
           -8: "a VOP that ends before its last macroblock", -9: "bad arguments",
           -10: "a coefficient out of range"}


def _lib():
    from hive_tpu_torch import native

    lib = native.get_native_lib()
    if lib is None:
        raise RuntimeError(f"MPEG-4 Part 2 video decodes in hive_tpu_torch's native library "
                           f"(native/src/mpeg4_decode.cpp, built with g++), which is not "
                           f"available: {native.build_error()}")
    return lib


def _pointers(*arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(*(a.ctypes.data for a in arrays))


def _params(headers_width: int, headers_height: int, vop: VopHeader, time_bits: int) -> np.ndarray:
    mbw, mbh = -(-headers_width // 16), -(-headers_height // 16)
    return np.array([mbw, mbh, headers_width, headers_height, vop.coding_type, vop.qscale,
                     vop.fcode, vop.rounding, vop.intra_dc_threshold, time_bits], np.int32)


def decode_macroblocks(sample: bytes, vop: VopHeader, headers: StreamHeaders,
                       reference: Optional[tuple]) -> tuple:
    """One coded VOP's picture at the coded size (Y, U, V)."""
    if vop.coding_type == P_VOP and reference is None:
        raise ValueError("an MPEG-4 P-VOP with no picture before it to predict from")
    mbw, mbh = -(-headers.width // 16), -(-headers.height // 16)
    out = (np.empty((16 * mbh, 16 * mbw), np.uint8), np.empty((8 * mbh, 8 * mbw), np.uint8),
           np.empty((8 * mbh, 8 * mbw), np.uint8))
    if reference is not None and [p.shape for p in reference] != [p.shape for p in out]:
        raise UnsupportedVideoError(
            f"An MPEG-4 Part 2 VOL changed the picture size to {headers.width}x"
            f"{headers.height} between a VOP and the one it predicts from; hive_tpu_torch "
            f"decodes one size a stream (ROADMAP.md {OTHER_CODEC_ITEM}).")
    params = _params(headers.width, headers.height, vop, headers.time_increment_bits)
    error_pos = ctypes.c_int64(0)
    status = _lib().hive_mpeg4_decode_vop(
        sample, len(sample), vop.bit_pos, params.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _pointers(*reference) if reference is not None else None, _pointers(*out),
        ctypes.byref(error_pos))
    if status:
        raise ValueError(f"corrupt MPEG-4 VOP: {_STATUS.get(status, status)} (bit "
                         f"{error_pos.value} of {8 * len(sample)})")
    return out


def scan_track(config: bytes, num_samples: int,
               read: Callable[[int, Optional[int]], bytes]) -> Tuple[StreamHeaders, np.ndarray]:
    """The stream's headers and, per sample, whether its VOP is coded (an
    N-VOP gives no frame); ``read(i, n)`` gives sample ``i``'s first ``n``
    bytes (all of them for None). Refuses, before any decode, what the
    decoder does not decode, in the headers and in every VOP header."""
    decoder = Mpeg4Decoder(config)
    coded = []
    for i in range(num_samples):
        data = read(i, 512)
        vop = data.find(VOP_START.to_bytes(4, "big"))
        if vop < 0 or vop + 64 > len(data):             # its VOP header may lie further
            data = read(i, None)
        coded.append(decoder.check(data).coded)
    return decoder.headers, np.asarray(coded, bool)


class Mpeg4Decoder:
    """Decodes a track's samples in order, from a sync sample on."""

    def __init__(self, config: bytes = b""):
        self.headers = StreamHeaders()
        if config:
            self.headers.parse(config)
        self.reference: Optional[tuple] = None

    def check(self, sample: bytes) -> VopHeader:
        """The sample's VOP header, after its in-band headers; refuses what
        is not decoded, before any decode."""
        found = self.headers.parse(sample)
        if not self.headers.have_vol:
            raise ValueError("an MPEG-4 Part 2 sample with no VOL header before it")
        if found is None:
            raise ValueError("an MPEG-4 Part 2 sample with no VOP")
        return parse_vop_header(sample, found, self.headers)

    def decode(self, sample: bytes) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The sample's picture cropped to the display size (Y, U, V), or
        None for an N-VOP."""
        vop = self.check(sample)
        if not vop.coded:
            return None
        self.reference = decode_macroblocks(sample, vop, self.headers, self.reference)
        h, w = self.headers.height, self.headers.width
        y, u, v = self.reference
        return y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2]


# ---------------------------------------------------------------------------
# The writer.
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.bits: List[int] = []

    def u(self, n: int, value: int) -> "_Writer":
        self.bits.extend((value >> i) & 1 for i in range(n - 1, -1, -1))
        return self

    def stuffing(self) -> "_Writer":
        self.u(1, 0)
        n = -len(self.bits) % 8
        return self.u(n, (1 << n) - 1)

    def bytes(self) -> bytes:
        return np.packbits(np.array(self.bits + [0] * (-len(self.bits) % 8), np.uint8)).tobytes()


def stream_config(width: int, height: int, time_resolution: int, *, resync_markers: bool,
                  user_data: bytes = b"") -> bytes:
    """VOS, VO, VOL and user data headers as FFmpeg's encoder writes them
    (Simple Profile L1, verid 1, low_delay, H.263 quantisation, no
    complexity estimation, progressive, 4:2:0)."""
    w = _Writer()
    w.u(32, VOS_START).u(8, 0x01)
    w.u(32, VO_START).u(1, 1).u(4, 1).u(3, 1).u(4, 1).u(1, 0).stuffing()
    w.u(32, 0x100)
    w.u(32, 0x120).u(1, 0).u(8, SIMPLE_VO_TYPE).u(1, 1).u(4, 1).u(3, 1).u(4, 1)
    w.u(1, 1).u(2, 1).u(1, 1).u(1, 0)                   # vol_control: 4:2:0, low_delay
    w.u(2, 0).u(1, 1).u(16, time_resolution).u(1, 1).u(1, 0)
    w.u(1, 1).u(13, width).u(1, 1).u(13, height).u(1, 1)
    w.u(1, 0).u(1, 1).u(1, 0).u(1, 0).u(1, 0)           # progressive, 8-bit, H.263 quant
    w.u(1, 1).u(1, 0 if resync_markers else 1).u(1, 0).u(1, 0).stuffing()
    config = w.bytes()
    if user_data:
        config += USER_DATA.to_bytes(4, "big") + user_data
    return config


def _vop_header(coding_type: int, seconds: int, increment: int, time_bits: int, qscale: int, *,
                coded: bool = True, rounding: int = 0, fcode: int = 1) -> _Writer:
    w = _Writer().u(32, VOP_START).u(2, coding_type)
    for _ in range(seconds):
        w.u(1, 1)
    w.u(1, 0).u(1, 1).u(time_bits, increment).u(1, 1).u(1, int(coded))
    if not coded:
        return w.stuffing()
    if coding_type == P_VOP:
        w.u(1, rounding)
    w.u(3, 0).u(5, qscale)                              # intra DC through its own VLC
    if coding_type == P_VOP:
        w.u(3, fcode)
    return w


def _gov_header(seconds: int) -> bytes:
    w = _Writer().u(32, GOV_START)
    w.u(5, seconds // 3600 % 24).u(6, seconds // 60 % 60).u(1, 1).u(6, seconds % 60)
    return w.u(1, 0).u(1, 0).stuffing().bytes()


def _fcode(mvs: np.ndarray) -> int:
    """The smallest vop_fcode_forward whose range holds every vector."""
    extent = int(max(mvs.max(), -mvs.min() - 1)) if mvs.size else 0
    for f in range(1, 8):
        if extent < 16 << f:
            return f
    raise ValueError(f"a motion vector of {extent} half-pels is outside MPEG-4's range")


def _pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    h, w = plane.shape
    return np.ascontiguousarray(np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge"))


PerFrame = Union[None, np.ndarray, Callable[[int], Optional[np.ndarray]]]


def _frame_value(value: PerFrame, index: int, grid: Tuple[int, int]) -> Optional[np.ndarray]:
    """``value`` for frame ``index``: a callable's answer, or an array that
    starts with the macroblock grid (every frame) or with a frame axis."""
    if value is None:
        return None
    if callable(value):
        return value(index)
    value = np.asarray(value)
    return value if value.shape[:2] == grid else value[index]


# What encode_vop counts, in the native encoder's order.
STAT_NAMES = ("escape1", "escape2", "escape3", "dquant", "intra", "four_mv", "not_coded",
              "ac_pred", "packets")


def encode_vop(planes, reference, header: _Writer, coding_type: int, qscale: int, fcode: int,
               rounding: int, time_bits: int, *, modes=None, qs=None, mvs=None,
               ac_pred: Optional[bool] = None, resync_every: int = 0) -> Tuple[bytes, np.ndarray]:
    """One VOP: ``header``'s bits, then the macroblocks of ``planes`` (Y, U,
    V at the coded size) coded against ``reference`` (a P-VOP's); and the
    counts of :data:`STAT_NAMES` it wrote."""
    height, width = planes[0].shape
    mbw, mbh = width // 16, height // 16
    vop = VopHeader(coding_type, True, rounding, qscale, fcode, 99)
    params = _params(width, height, vop, time_bits)
    keep = [np.ascontiguousarray(a, np.int32) if a is not None else None for a in (modes, qs, mvs)]
    capacity = 1024 + 4 * 400 * mbw * mbh
    out = np.empty(capacity, np.uint8)
    prefix = header.bytes()
    stats = np.zeros(len(STAT_NAMES), np.int64)
    n = _lib().hive_mpeg4_encode_vop(
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _pointers(*planes),
        _pointers(*reference) if reference is not None else None,
        *(a.ctypes.data if a is not None else None for a in keep),
        {None: 2, False: 0, True: 1}[ac_pred], resync_every, prefix, len(header.bits),
        out.ctypes.data, capacity, stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if n < 0:
        raise ValueError(f"MPEG-4 VOP encode failed: {_STATUS.get(int(n), int(n))}")
    return out[:n].tobytes(), stats


def write_mpeg4_mp4(path: str, frames: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], *,
                    gop: int = 12, qscale: int = 4,
                    motion: PerFrame = None, four_mv: PerFrame = None, intra: PerFrame = None,
                    not_coded: PerFrame = None, mb_qscale: PerFrame = None,
                    ac_pred: Optional[bool] = None, resync_every: int = 0,
                    n_vops: Sequence[int] = (), user_data: bytes = b"",
                    edits: Sequence[Tuple[int, int]] = ()) -> dict:
    """Write ``frames`` (uint8 Y, U, V planes of an even size, display
    order; may be lazy) as an MPEG-4 Part 2 Simple Profile ``.mp4`` at
    30 fps.

    Per macroblock, for each P-VOP (each option an array of the macroblock
    grid, the same for every frame, or with a leading frame axis, or a
    callable of the frame index): ``motion`` half-pel vectors (mbh, mbw, 2),
    or (mbh, mbw, 4, 2) for ``four_mv`` macroblocks (bool); ``intra`` and
    ``not_coded`` macroblocks (bool); ``mb_qscale`` the wanted quantiser
    (reached in DQUANT steps of at most 2; 4MV macroblocks keep theirs).
    ``ac_pred``: AC prediction always (True), never (False) or where it
    saves bits (None). ``resync_every``: a video packet every that many
    macroblocks (0: none, and the VOL says resync markers are off).
    ``n_vops``: frame indices coded as N-VOPs (``vop_coded`` 0: no picture).
    An I-VOP starts every ``gop`` coded frames. Returns the counts of
    :data:`STAT_NAMES` over the file, plus ``p_vops`` and ``rounding_1``
    (P-VOPs of rounding type 1)."""
    timescale, duration = 30, 1
    height, width = frames[0][0].shape
    if width % 2 or height % 2:
        raise ValueError(f"MPEG-4 4:2:0 frames need an even size, not {width}x{height}")
    mbw, mbh = -(-width // 16), -(-height // 16)
    config = stream_config(width, height, timescale, resync_markers=resync_every > 0,
                           user_data=user_data)
    time_bits = max(av_log2(timescale - 1) + 1, 1)
    headers = StreamHeaders(width=width, height=height, time_increment_bits=time_bits,
                            have_vol=True)
    skipped = set(n_vops)
    sync: List[bool] = []                               # filled as the samples are written
    totals = dict.fromkeys(STAT_NAMES + ("p_vops", "rounding_1"), 0)

    def samples() -> Iterator[bytes]:
        reference = None
        coded = 0
        rounding = 0
        last_second = 0
        for i in range(len(frames)):
            t = i * duration
            second, increment = t // timescale, t % timescale
            ticks = second - last_second
            last_second = second
            if i in skipped:
                sync.append(False)
                yield _vop_header(P_VOP, ticks, increment, time_bits, qscale,
                                  coded=False).bytes()
                continue
            y, u, v = frames[i]
            planes = (_pad(y, 16 * mbh, 16 * mbw), _pad(u, 8 * mbh, 8 * mbw),
                      _pad(v, 8 * mbh, 8 * mbw))
            is_i = coded % gop == 0
            coded += 1
            sync.append(is_i)
            qs = _frame_value(mb_qscale, i, (mbh, mbw))
            if is_i:
                rounding = 0
                header = _vop_header(I_VOP, 0, increment, time_bits, qscale)
                gov = _gov_header(second)
                body, stats = encode_vop(planes, None, header, I_VOP, qscale, 1, 0, time_bits,
                                         qs=qs, ac_pred=ac_pred, resync_every=resync_every)
                sample = gov + body
                last_second = second
                vop = VopHeader(I_VOP, True, 0, qscale, 1, 99, 8 * len(gov) + len(header.bits))
            else:
                rounding ^= 1
                modes = np.zeros((mbh, mbw), np.int32)
                for value, mode in ((four_mv, 1), (intra, 2), (not_coded, 3)):
                    mask = _frame_value(value, i, (mbh, mbw))
                    if mask is not None:
                        modes[np.asarray(mask, bool)] = mode
                mvs = np.zeros((mbh, mbw, 4, 2), np.int32)
                field_ = _frame_value(motion, i, (mbh, mbw))
                if field_ is not None:
                    field_ = np.asarray(field_, np.int32)
                    mvs[:] = field_ if field_.ndim == 4 else field_.reshape(mbh, mbw, 1, 2)
                used = np.where((modes == 1)[..., None, None], mvs,
                                np.where((modes == 0)[..., None, None], mvs[:, :, :1], 0))
                fcode = _fcode(used)
                header = _vop_header(P_VOP, ticks, increment, time_bits, qscale,
                                     rounding=rounding, fcode=fcode)
                sample, stats = encode_vop(planes, reference, header, P_VOP, qscale, fcode,
                                           rounding, time_bits, modes=modes, qs=qs, mvs=mvs,
                                           ac_pred=ac_pred, resync_every=resync_every)
                totals["p_vops"] += 1
                totals["rounding_1"] += rounding
                vop = VopHeader(P_VOP, True, rounding, qscale, fcode, 99, len(header.bits))
            for name, count in zip(STAT_NAMES, stats.tolist()):
                totals[name] += count
            reference = decode_macroblocks(sample, vop, headers, reference)
            yield sample

    entry = mp4.mp4v_entry(width, height, mp4.MPEG4_PART2_OTI, config)
    mp4.write_mp4(path, entry, samples(), width=width, height=height, timescale=timescale,
                  durations=[duration] * len(frames), sync=sync, edits=edits)
    return totals
