"""The I_PCM subset of H.264, both ways.

In an ``I_PCM`` macroblock the stream carries the raw 8-bit Y, Cb and Cr
samples (256 + 64 + 64 bytes), so a stream made only of such macroblocks
decodes losslessly and every decoder must return the samples it was given.
That makes it the fixture that holds the port's decoders, NVDEC on the card
and :class:`PcmDecoder` on the CPU, and OpenCV's FFmpeg, to known planes.

**The writer** (:func:`write_pcm_mp4`) makes
Baseline-profile CAVLC streams: the first picture IDR, the others non-IDR
I slices, one slice a picture, every macroblock ``I_PCM`` (``mb_type`` 25)
and ``disable_deblocking_filter_idc = 1``; POC type 0 (the display index
times two); SPS frame cropping for sizes that are not multiples of 16;
emulation-prevention bytes; ``level_idc`` 51, which admits 1920 x 1440.
With ``reorder`` the pictures are coded out of order (display 0, 2, 1, 4,
3, ...; the odd ones non-reference), the MP4 carries ``ctts`` and the VUI's
``bitstream_restriction`` says ``max_num_reorder_frames = 1``. The VUI can
also signal full range and a BT.709 colour description.

**The reader** (:class:`PcmDecoder`) is the port's decode path on the CPU.
It parses SPS, PPS and slice headers (CAVLC, 4:2:0, 8-bit, frame pictures,
POC type 0) and takes ``I_PCM`` macroblocks; it refuses any other
``mb_type``, slice type or stream feature outside that subset, naming it.
On a CUDA device the port decodes through NVDEC instead
(:mod:`hive_tpu_torch.video.nvdec`), never through this reader.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from hive_tpu_torch.video import mp4

NAL_SLICE, NAL_IDR, NAL_SPS, NAL_PPS = 1, 5, 7, 8
MB_I_PCM = 25
LEVEL_IDC = 51
LOG2_MAX_FRAME_NUM = 8
LOG2_MAX_POC_LSB = 16
# ITU-T H.264 Table 7-11.
_I_MB_TYPES = ["I_NxN"] + [f"I_16x16_{pred}_{cbpc}_{cbpl}" for cbpl in (0, 15)
                           for cbpc in (0, 1, 2) for pred in (0, 1, 2, 3)] + ["I_PCM"]
_SLICE_TYPES = ["P", "B", "I", "SP", "SI"]
# The reader's subset, named in its refusals.
SUBSET = ("the I_PCM subset of H.264 (CAVLC, 4:2:0, 8-bit, frame pictures, POC type 0, "
          "every macroblock I_PCM)")


class UnsupportedStreamError(ValueError):
    """An H.264 stream outside the CPU reader's subset."""


def _refuse(what: str) -> UnsupportedStreamError:
    return UnsupportedStreamError(
        f"{what}: the CPU reader decodes only {SUBSET}; decode this video on a CUDA device "
        f"(NVDEC)")


# ---------------------------------------------------------------------------
# Bits.
# ---------------------------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def u(self, n: int, value: int) -> "BitWriter":
        self.bits.extend((value >> i) & 1 for i in range(n - 1, -1, -1))
        return self

    def ue(self, value: int) -> "BitWriter":
        code = value + 1
        return self.u(code.bit_length() - 1, 0).u(code.bit_length(), code)

    def se(self, value: int) -> "BitWriter":
        return self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align(self, stop_bit: bool) -> bytes:
        """The bits as bytes, after an optional stop bit and zero padding."""
        if stop_bit:
            self.u(1, 1)
        self.bits.extend([0] * (-len(self.bits) % 8))
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        first, last = self.pos >> 3, (self.pos + n + 7) >> 3
        if last > len(self.data):
            raise ValueError("H.264 syntax element past the end of its NAL unit")
        word = int.from_bytes(self.data[first:last], "big")
        value = (word >> ((last << 3) - self.pos - n)) & ((1 << n) - 1)
        self.pos += n
        return value

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("corrupt Exp-Golomb code")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def byte_aligned(self) -> int:
        """Skip to the next byte boundary; the byte offset there."""
        self.pos = -(-self.pos // 8) * 8
        return self.pos >> 3


def escape(rbsp: np.ndarray) -> np.ndarray:
    """Insert emulation-prevention bytes (0x03) into an RBSP, as H.264 7.4.1
    asks: after two zero bytes whenever the next byte is 0-3, and at the end
    when the payload ends with a zero."""
    rbsp = np.asarray(rbsp, np.uint8)
    zero = np.concatenate([[False], rbsp == 0, [False]]).astype(np.int8)
    edges = np.diff(zero)
    starts, ends = np.flatnonzero(edges == 1), np.flatnonzero(edges == -1)
    lengths = ends - starts
    at: List[np.ndarray] = []
    # Inside each run of k zeros, before zeros 2, 4, ... (< k).
    long = lengths > 2
    if long.any():
        counts = (lengths[long] - 1) // 2
        base = np.repeat(starts[long], counts)
        step = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        at.append(base + 2 + 2 * step)
    # After a run of an even length, before a following byte of 1-3 (or at
    # the end of the payload).
    even = (lengths % 2 == 0)
    after = ends[even]
    nxt = np.where(after < len(rbsp), rbsp[np.minimum(after, len(rbsp) - 1)], 0)
    at.append(after[nxt <= 3])
    at = np.sort(np.concatenate(at))
    return np.insert(rbsp, at, np.uint8(3))


def unescape(nal: bytes) -> bytes:
    """Remove emulation-prevention bytes: each 0x03 after two zero bytes."""
    data = np.frombuffer(nal, np.uint8)
    if len(data) < 3:
        return bytes(nal)
    hit = np.flatnonzero((data[2:] == 3) & (data[1:-1] == 0) & (data[:-2] == 0)) + 2
    if len(hit) == 0:
        return bytes(nal)
    keep = np.ones(len(data), bool)
    keep[hit] = False
    return data[keep].tobytes()


def nal_unit(ref_idc: int, nal_type: int, rbsp: np.ndarray) -> bytes:
    return bytes([(ref_idc << 5) | nal_type]) + escape(rbsp).tobytes()


# ---------------------------------------------------------------------------
# The writer.
# ---------------------------------------------------------------------------

def _mb_size(n: int) -> int:
    return -(-n // 16)


def encode_sps(width: int, height: int, *, reorder: bool = False, full_range: bool = False,
               matrix: Optional[int] = None) -> bytes:
    """Baseline profile SPS (constraint sets 0 and 1: constrained
    baseline), one reference frame, cropped to ``width`` x ``height``;
    ``matrix`` is the VUI colour description's ``matrix_coefficients``
    (1 for BT.709; its primaries and transfer carry the same number)."""
    if width % 2 or height % 2:
        raise ValueError(f"4:2:0 needs an even frame size, not {width}x{height}")
    mbs_w, mbs_h = _mb_size(width), _mb_size(height)
    bits = BitWriter().u(8, 66).u(8, 0b11000000).u(8, LEVEL_IDC).ue(0)
    bits.ue(LOG2_MAX_FRAME_NUM - 4).ue(0).ue(LOG2_MAX_POC_LSB - 4)
    bits.ue(1).u(1, 0).ue(mbs_w - 1).ue(mbs_h - 1).u(1, 1).u(1, 1)
    crop_right, crop_bottom = (16 * mbs_w - width) // 2, (16 * mbs_h - height) // 2
    cropped = bool(crop_right or crop_bottom)
    bits.u(1, cropped)
    if cropped:
        bits.ue(0).ue(crop_right).ue(0).ue(crop_bottom)
    signal = full_range or matrix is not None
    vui = signal or reorder
    bits.u(1, vui)
    if vui:
        bits.u(1, 0).u(1, 0).u(1, signal)
        if signal:
            bits.u(3, 5).u(1, full_range).u(1, matrix is not None)
            if matrix is not None:
                bits.u(8, matrix).u(8, matrix).u(8, matrix)
        bits.u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, reorder)
        if reorder:
            bits.u(1, 1).ue(0).ue(0).ue(16).ue(16).ue(1).ue(1)
    return nal_unit(3, NAL_SPS, np.frombuffer(bits.align(True), np.uint8))


def encode_pps() -> bytes:
    """CAVLC, one slice group, deblocking control present."""
    bits = BitWriter().ue(0).ue(0).u(1, 0).u(1, 0).ue(0).ue(0).ue(0).u(1, 0).u(2, 0)
    bits.se(0).se(0).se(0).u(1, 1).u(1, 0).u(1, 0)
    return nal_unit(3, NAL_PPS, np.frombuffer(bits.align(True), np.uint8))


def _macroblocks(y: np.ndarray, u: np.ndarray, v: np.ndarray, mbs_w: int,
                 mbs_h: int) -> np.ndarray:
    """(macroblocks, 384) raw samples in raster order, the planes padded to
    whole macroblocks by repeating their last row and column."""
    def padded(plane, block):
        h, w = plane.shape
        return np.pad(plane, ((0, mbs_h * block - h), (0, mbs_w * block - w)), mode="edge")

    def tiles(plane, block):
        return (padded(plane, block).reshape(mbs_h, block, mbs_w, block)
                .transpose(0, 2, 1, 3).reshape(mbs_h * mbs_w, block * block))

    return np.concatenate([tiles(y, 16), tiles(u, 8), tiles(v, 8)], axis=1)


def encode_picture(y: np.ndarray, u: np.ndarray, v: np.ndarray, *, idr: bool,
                   reference: bool, frame_num: int, poc: int) -> bytes:
    """One picture as one I slice NAL unit of I_PCM macroblocks."""
    h, w = y.shape
    mbs_w, mbs_h = _mb_size(w), _mb_size(h)
    bits = BitWriter().ue(0).ue(7).ue(0).u(LOG2_MAX_FRAME_NUM, frame_num)
    if idr:
        bits.ue(0)
    bits.u(LOG2_MAX_POC_LSB, poc % (1 << LOG2_MAX_POC_LSB))
    if reference:                              # dec_ref_pic_marking: all flags 0
        bits.u(2 if idr else 1, 0)
    bits.se(0).ue(1)                           # slice_qp_delta; no deblocking
    bits.ue(MB_I_PCM)                          # the first macroblock's mb_type
    header = np.frombuffer(bits.align(False), np.uint8)
    samples = _macroblocks(y, u, v, mbs_w, mbs_h)
    body = np.empty((len(samples), 386), np.uint8)
    body[:, 0], body[:, 1] = 0x0D, 0x00        # ue(25) and pcm_alignment_zero_bits
    body[:, 2:] = samples
    rbsp = np.concatenate([header, body.reshape(-1)[2:], [0x80]]).astype(np.uint8)
    nal_type = NAL_IDR if idr else NAL_SLICE
    return nal_unit(3 if idr else 2 if reference else 0, nal_type, rbsp)


def coding_order(num_frames: int, reorder: bool) -> List[int]:
    """Display indices in decode order: in order, or 0, 2, 1, 4, 3, ..."""
    if not reorder:
        return list(range(num_frames))
    order = [0]
    for k in range(1, num_frames, 2):
        order += [k + 1, k] if k + 1 < num_frames else [k]
    return order


def write_pcm_mp4(path: str, frames: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], *,
                  fps: Tuple[int, int] = (30, 1), reorder: bool = False,
                  full_range: bool = False, matrix: Optional[int] = None, rotation: int = 0,
                  edit_frames: Optional[int] = None,
                  edits: Optional[Sequence[Tuple[int, int]]] = None,
                  idr_every: Optional[int] = None) -> None:
    """Write ``frames`` (uint8 Y, U, V planes in display order; ``frames``
    may be a lazy sequence) as an I_PCM H.264 MP4 at ``fps`` = (timescale,
    frame duration), e.g. (30, 1) or (30000, 1001); ``full_range`` and
    ``matrix`` go into the SPS's VUI (:func:`encode_sps`). ``rotation`` is the
    display matrix's clockwise rotation; ``edit_frames`` starts the
    track's one edit that many frames into the media, or ``edits`` gives
    the edit list itself ((duration, media time) in timescale units).
    Sample 0 is the one IDR (sync) picture, or every ``idr_every``-th is
    (in order only)."""
    height, width = frames[0][0].shape
    n = len(frames)
    if idr_every is not None and reorder:
        raise ValueError("idr_every needs frames in order")
    order = coding_order(n, reorder)
    idr = [i % idr_every == 0 if idr_every else i == 0 for i in range(n)]
    sps = encode_sps(width, height, reorder=reorder, full_range=full_range, matrix=matrix)
    timescale, duration = fps
    # Decode times are the decode index; composition times the display
    # index, shifted one frame later when reordered (ctts stays >= 0).
    delay = 1 if reorder else 0
    cts_offsets = [(k + delay - i) * duration for i, k in enumerate(order)] if reorder else None
    if edits is None:
        edits = []
        if edit_frames is not None:
            edits = [((n - edit_frames) * duration, (edit_frames + delay) * duration)]
        elif reorder:
            edits = [(n * duration, delay * duration)]

    def samples():
        # Out of order, the odd display indices are non-reference pictures;
        # frame_num counts reference pictures since the last IDR.
        prev_ref = 0
        for i, k in enumerate(order):
            reference = not reorder or k % 2 == 0
            frame_num = 0 if idr[i] else (prev_ref + 1) % (1 << LOG2_MAX_FRAME_NUM)
            if reference:
                prev_ref = frame_num
            nal = encode_picture(*frames[k], idr=idr[i], reference=reference,
                                 frame_num=frame_num, poc=2 * k)
            yield len(nal).to_bytes(4, "big") + nal

    mp4.write_mp4(path, mp4.avc1_entry(width, height, sps, encode_pps()), samples(),
                  width=width, height=height, timescale=timescale,
                  durations=[duration] * n, cts_offsets=cts_offsets,
                  sync=idr, rotation=rotation, edits=edits)


# ---------------------------------------------------------------------------
# The reader.
# ---------------------------------------------------------------------------

def parse_sps(rbsp: bytes) -> dict:
    """The fields of an SPS (its NAL header byte first, emulation
    prevention removed) that the port reads: sizes, cropping, POC type,
    the VUI's colour description and reorder depth."""
    r = BitReader(rbsp, 8)
    profile = r.u(8)
    r.u(16)
    sps = dict(id=r.ue(), profile=profile, chroma_format=1, bit_depth=8,
               scaling_matrices=False, full_range=False, matrix=2, reorder=None)
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        sps["chroma_format"] = r.ue()
        if sps["chroma_format"] == 3:
            r.u(1)
        sps["bit_depth"] = 8 + max(r.ue(), r.ue())
        r.u(1)
        if r.u(1):
            sps["scaling_matrices"] = True
            for i in range(8 if sps["chroma_format"] != 3 else 12):
                if r.u(1):
                    last = following = 8
                    for _ in range(16 if i < 6 else 64):
                        if following:
                            following = (last + r.se() + 256) % 256
                        last = following or last
    sps["log2_max_frame_num"] = r.ue() + 4
    sps["poc_type"] = r.ue()
    if sps["poc_type"] == 0:
        sps["log2_max_poc_lsb"] = r.ue() + 4
    elif sps["poc_type"] == 1:
        r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()                                         # max_num_ref_frames
    r.u(1)
    sps["mbs_w"], map_units_h = r.ue() + 1, r.ue() + 1
    sps["frame_mbs_only"] = r.u(1)
    if not sps["frame_mbs_only"]:
        r.u(1)
    sps["mbs_h"] = map_units_h * (2 - sps["frame_mbs_only"])
    r.u(1)
    sps["crop"] = (r.ue(), r.ue(), r.ue(), r.ue()) if r.u(1) else (0, 0, 0, 0)
    left, right, top, bottom = sps["crop"]
    sps["width"] = 16 * sps["mbs_w"] - 2 * (left + right)
    sps["height"] = 16 * sps["mbs_h"] - 2 * (2 - sps["frame_mbs_only"]) * (top + bottom)
    if r.u(1):                                     # VUI
        if r.u(1) and r.u(8) == 255:               # aspect ratio
            r.u(32)
        if r.u(1):                                 # overscan
            r.u(1)
        if r.u(1):                                 # video signal type
            r.u(3)
            sps["full_range"] = bool(r.u(1))
            if r.u(1):
                r.u(16)
                sps["matrix"] = r.u(8)
        if r.u(1):                                 # chroma location
            r.ue()
            r.ue()
        if r.u(1):                                 # timing
            r.u(65)
        nal_hrd = r.u(1)
        if nal_hrd:
            _skip_hrd(r)
        vcl_hrd = r.u(1)
        if vcl_hrd:
            _skip_hrd(r)
        if nal_hrd or vcl_hrd:
            r.u(1)
        r.u(1)
        if r.u(1):                                 # bitstream restriction
            r.u(1)
            for _ in range(4):
                r.ue()
            sps["reorder"] = r.ue()
            r.ue()
    if sps["reorder"] is None:
        sps["reorder"] = 16
    return sps


def _skip_hrd(r: BitReader) -> None:
    count = r.ue() + 1
    r.u(8)
    for _ in range(count):
        r.ue()
        r.ue()
        r.u(1)
    r.u(20)


@dataclass
class Picture:
    poc: int
    idr: bool
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    sample: int = -1     # the MP4 sample it came from, if the caller says


class PcmDecoder:
    """Decodes the I_PCM subset: feed it access units (lists of NAL units,
    emulation prevention still in) in decode order with :meth:`decode`;
    :func:`display_order` puts the pictures in display order."""

    def __init__(self):
        self.sps: dict = {}
        self.pps: dict = {}
        self.prev_poc_msb = 0
        self.prev_poc_lsb = 0

    # -- parameter sets -------------------------------------------------------
    def _parse_sps(self, rbsp: bytes) -> None:
        sps = parse_sps(rbsp)
        if sps["bit_depth"] != 8:
            raise _refuse(f"The stream's samples are {sps['bit_depth']}-bit")
        if sps["chroma_format"] != 1:
            raise _refuse(f"The stream's chroma format is "
                          f"{('4:0:0', '4:2:0', '4:2:2', '4:4:4')[sps['chroma_format']]}")
        if sps["scaling_matrices"]:
            raise _refuse("The SPS carries scaling matrices")
        if sps["poc_type"] != 0:
            raise _refuse(f"The stream uses pic_order_cnt_type {sps['poc_type']}")
        if not sps["frame_mbs_only"]:
            raise _refuse("The stream codes fields (frame_mbs_only_flag = 0)")
        self.sps[sps["id"]] = sps

    def _parse_pps(self, rbsp: bytes) -> None:
        r = BitReader(rbsp, 8)
        pps_id, sps_id = r.ue(), r.ue()
        if r.u(1):
            raise _refuse("The stream is CABAC-coded")
        bottom_field_poc = r.u(1)
        if r.ue() != 0:
            raise _refuse("The stream uses slice groups")
        r.ue()
        r.ue()
        r.u(3)
        r.se()
        r.se()
        r.se()
        deblocking_control = r.u(1)
        r.u(1)
        if r.u(1):
            raise _refuse("The stream carries redundant pictures")
        self.pps[pps_id] = dict(sps_id=sps_id, deblocking_control=deblocking_control,
                                bottom_field_poc=bottom_field_poc)

    # -- pictures -------------------------------------------------------------
    def decode(self, nal_units: Iterable[bytes]) -> Optional[Picture]:
        """Decode one access unit; the picture it holds, or None."""
        picture = None
        for nal in nal_units:
            nal_type = nal[0] & 0x1F
            if nal_type == NAL_SPS:
                self._parse_sps(unescape(nal))
            elif nal_type == NAL_PPS:
                self._parse_pps(unescape(nal))
            elif nal_type in (NAL_SLICE, NAL_IDR):
                picture = self._decode_slice(unescape(nal), nal_type == NAL_IDR,
                                             nal[0] >> 5, picture)
            elif nal_type in (2, 3, 4, 20, 21):
                raise _refuse(f"The stream carries NAL units of type {nal_type}")
        if picture is None:
            return None
        sps = picture.pop("sps")
        if not picture.pop("filled").all():
            raise ValueError("an access unit left macroblocks undecoded")
        left, right, top, bottom = (2 * c for c in sps["crop"])
        h, w = picture["y"].shape
        y = picture["y"][top:h - bottom, left:w - right]
        u = picture["u"][top // 2:(h - bottom) // 2, left // 2:(w - right) // 2]
        v = picture["v"][top // 2:(h - bottom) // 2, left // 2:(w - right) // 2]
        return Picture(picture["poc"], picture["idr"], y, u, v)

    def _decode_slice(self, rbsp: bytes, idr: bool, ref_idc: int, picture):
        r = BitReader(rbsp, 8)
        first_mb = r.ue()
        slice_type = r.ue()
        if slice_type % 5 != 2:
            raise _refuse(f"The stream has {_SLICE_TYPES[slice_type % 5]} slices")
        pps = self.pps[r.ue()]
        sps = self.sps[pps["sps_id"]]
        r.u(sps["log2_max_frame_num"])
        if idr:
            r.ue()
        poc_lsb = r.u(sps["log2_max_poc_lsb"])
        if pps["bottom_field_poc"]:
            r.se()
        if ref_idc:
            if idr:
                r.u(2)
            elif r.u(1):
                raise _refuse("The stream uses adaptive reference picture marking")
        r.se()                                     # slice_qp_delta
        if pps["deblocking_control"] and r.ue() != 1:
            r.se()
            r.se()

        if picture is None:
            max_lsb = 1 << sps["log2_max_poc_lsb"]
            if idr:
                self.prev_poc_msb = self.prev_poc_lsb = 0
            msb = self.prev_poc_msb
            if poc_lsb < self.prev_poc_lsb and self.prev_poc_lsb - poc_lsb >= max_lsb // 2:
                msb += max_lsb
            elif poc_lsb > self.prev_poc_lsb and poc_lsb - self.prev_poc_lsb > max_lsb // 2:
                msb -= max_lsb
            if ref_idc:
                self.prev_poc_msb, self.prev_poc_lsb = msb, poc_lsb
            h, w = 16 * sps["mbs_h"], 16 * sps["mbs_w"]
            picture = dict(poc=msb + poc_lsb, idr=idr, sps=sps,
                           y=np.empty((h, w), np.uint8), u=np.empty((h // 2, w // 2), np.uint8),
                           v=np.empty((h // 2, w // 2), np.uint8),
                           filled=np.zeros(sps["mbs_h"] * sps["mbs_w"], bool))

        def refuse_mb(position: int):
            mb_type = BitReader(rbsp, position).ue()
            name = _I_MB_TYPES[mb_type] if mb_type < len(_I_MB_TYPES) else f"mb_type {mb_type}"
            return _refuse(f"The stream has a macroblock of type {name}")

        position = r.pos
        if r.ue() != MB_I_PCM:
            raise refuse_mb(position)
        # After the first macroblock's samples, each macroblock is byte
        # aligned: ue(25) and its alignment bits (0x0D 0x00), 384 samples;
        # then the stop bit (0x80).
        start = r.byte_aligned()
        data = np.frombuffer(rbsp, np.uint8)[start:]
        if len(data) < 385 or (len(data) - 385) % 386 or data[-1] != 0x80:
            pos = 384
            while pos + 386 < len(data) and data[pos] == 0x0D and data[pos + 1] == 0:
                pos += 386
            if pos + 2 >= len(data):
                raise ValueError("an I_PCM slice ends inside a macroblock")
            raise refuse_mb(8 * (start + pos))
        body = np.concatenate([np.array([0x0D, 0x00], np.uint8), data[:-1]])
        mbs = body.reshape(-1, 386)
        bad = np.flatnonzero((mbs[:, 0] != 0x0D) | (mbs[:, 1] != 0))
        if len(bad):
            raise refuse_mb(8 * (start + 386 * int(bad[0]) - 2))
        if first_mb + len(mbs) > sps["mbs_w"] * sps["mbs_h"]:
            raise ValueError("a slice runs past the picture's last macroblock")
        index = np.arange(first_mb, first_mb + len(mbs))
        picture["filled"][index] = True
        rows, cols = index // sps["mbs_w"], index % sps["mbs_w"]
        samples = mbs[:, 2:]
        _scatter(picture["y"], samples[:, :256], rows, cols, 16)
        _scatter(picture["u"], samples[:, 256:320], rows, cols, 8)
        _scatter(picture["v"], samples[:, 320:], rows, cols, 8)
        return picture


def _scatter(plane: np.ndarray, blocks: np.ndarray, rows: np.ndarray, cols: np.ndarray,
             size: int) -> None:
    mbs_w = plane.shape[1] // size
    if len(rows) == plane.size // (size * size):
        plane[:] = (blocks.reshape(-1, mbs_w, size, size).transpose(0, 2, 1, 3)
                    .reshape(plane.shape))
        return
    for block, row, col in zip(blocks, rows, cols):
        plane[row * size:(row + 1) * size, col * size:(col + 1) * size] = \
            block.reshape(size, size)


def display_order(pictures: Iterable[Picture], reorder: int) -> Iterator[Picture]:
    """Pictures in display order: a buffer of ``reorder`` pictures ordered
    by POC, flushed at each IDR and at the end (H.264 C.4.5.3's bumping,
    with the DPB as deep as the SPS's ``max_num_reorder_frames``)."""
    heap: list = []
    count = 0
    for picture in pictures:
        if picture.idr:
            while heap:
                yield heapq.heappop(heap)[2]
        heapq.heappush(heap, (picture.poc, count, picture))
        count += 1
        if len(heap) > reorder:
            yield heapq.heappop(heap)[2]
    while heap:
        yield heapq.heappop(heap)[2]
