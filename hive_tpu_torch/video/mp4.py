"""An ISO-BMFF (MP4 / MOV) demuxer and muxer, written by hand.

The demuxer reads a file's first video track as ``cv2.VideoCapture``'s
FFmpeg backend sees it: the ``moov`` sample tables (``stsd``, ``stts``,
``ctts``, ``stsc``, ``stsz`` / ``stz2``, ``stco`` / ``co64``, ``stss``),
``mdhd``'s timescale, ``tkhd``'s display matrix and ``elst``. It gives

* the codec, by sample entry: H.264 for ``avc1`` / ``avc3`` (each sample's
  length-prefixed NAL units as an Annex-B access unit, the SPS and PPS from
  ``avcC`` put before each sync sample); HEVC for ``hvc1`` / ``hev1`` (the
  ``hvcC`` record's NAL length size and VPS / SPS / PPS arrays; ``hev1``
  may carry parameter sets in its samples too); Motion JPEG for ``jpeg``,
  ``mjpa`` and ``mp4v`` whose ``esds`` names JPEG (objectTypeIndication
  0x6C, what cv2's ``MJPG`` writer stores in an ``.mp4``), each sample one
  JPEG and every sample a sync sample; MPEG-4 Part 2 for ``mp4v`` whose
  ``esds`` names it (objectTypeIndication 0x20, what cv2's default ``mp4v``
  writer stores), its DecoderSpecificInfo (the VOS, VO and VOL headers) as
  the track's ``config``;
* the frame size after the SPS's cropping (1080 lines coded as 1088 read as
  1080) and after the display matrix's rotation, which OpenCV applies to
  the frames and to ``CAP_PROP_FRAME_WIDTH`` / ``HEIGHT``
  (``CAP_PROP_ORIENTATION_AUTO`` is on by default);
* ``CAP_PROP_FPS`` as FFmpeg's MP4 reader computes ``avg_frame_rate``: the
  media timescale times the sample count over the sum of the ``stts``
  durations;
* the frames a reader returns, in order (:meth:`VideoTrack.segments`): the
  edit list applied as FFmpeg's ``mov_fix_index`` applies it. Each edit
  decodes from the key frame at or before its media time and keeps the
  frames whose composition time (``dts + ctts``) lies in ``[media_time,
  media_time + segment duration)``; leading empty edits only delay the
  track; an edit may repeat samples another one showed.

Refused, naming the codec and the ROADMAP item: ``mp4v`` of any other
object type, ``mjpb`` and any other sample entry. The muxer
(:func:`write_mp4`) writes the same boxes, for the H.264 writer of
:mod:`hive_tpu_torch.video.h264`, the HEVC writer of
:mod:`hive_tpu_torch.video.hevc`, for Motion JPEG
(:func:`mjpeg_entry`) and for the MPEG-4 Part 2 writer of
:mod:`hive_tpu_torch.video.mpeg4`.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# The ROADMAP item of the codecs the port does not decode yet.
OTHER_CODEC_ITEM = "Queue 1 item 9d"

# The codecs the port decodes, and the sample entries that carry them.
H264, HEVC, MJPEG, MPEG4 = "h264", "hevc", "mjpeg", "mpeg4"
_H264_ENTRIES = (b"avc1", b"avc3")
_HEVC_ENTRIES = (b"hvc1", b"hev1")
_MJPEG_ENTRIES = (b"jpeg", b"mjpa")
# ISO/IEC 14496-1 objectTypeIndication values of an mp4v entry's esds.
JPEG_OTI, MPEG4_PART2_OTI = 0x6C, 0x20

CODEC_NAMES = {b"mp4v": "MPEG-4 Part 2 (mp4v)", b"av01": "AV1", b"vp09": "VP9",
               b"mjpb": "Motion JPEG B", b"apch": "ProRes", b"apcn": "ProRes"}
_OTI_NAMES = {0x21: "H.264 in an mp4v entry", 0x6A: "MPEG-1 video", 0x6D: "PNG",
              **{oti: "MPEG-2 video" for oti in range(0x60, 0x66)}}

START_CODE = b"\x00\x00\x00\x01"


class UnsupportedVideoError(ValueError):
    """A video the port does not decode, named with its ROADMAP item."""


def _refuse_codec(fourcc: bytes, oti: Optional[int] = None) -> UnsupportedVideoError:
    name = CODEC_NAMES.get(fourcc, fourcc.decode("latin-1"))
    entry = f"sample entry '{fourcc.decode('latin-1')}'"
    if fourcc == b"mp4v":
        name = _OTI_NAMES.get(oti, name)
        entry += (", no objectTypeIndication" if oti is None
                  else f", objectTypeIndication 0x{oti:02X}")
    return UnsupportedVideoError(
        f"The video's codec is {name} ({entry}); hive_tpu_torch decodes only H.264 (avc1 / "
        f"avc3), HEVC (hvc1 / hev1), Motion JPEG (jpeg, mjpa, mp4v of objectTypeIndication "
        f"0x6C) and MPEG-4 Part 2 (mp4v of objectTypeIndication 0x20) so far (ROADMAP.md "
        f"{OTHER_CODEC_ITEM}).")


def _descriptor(data: bytes, pos: int) -> Tuple[int, int, int]:
    """(tag, payload start, payload size) of an ISO/IEC 14496-1 descriptor
    at ``pos``: its size takes 1-4 bytes of 7 bits each."""
    tag, pos, size = data[pos], pos + 1, 0
    for _ in range(4):
        byte = data[pos]
        pos += 1
        size = size << 7 | byte & 0x7F
        if not byte & 0x80:
            break
    return tag, pos, size


def esds_decoder_config(data: bytes, start: int) -> Tuple[Optional[int], bytes]:
    """(objectTypeIndication, DecoderSpecificInfo bytes) of the
    DecoderConfigDescriptor in an ``esds`` box whose payload starts at
    ``start``; (None, b"") without one, b"" without the specific info."""
    tag, pos, _ = _descriptor(data, start + 4)             # after version, flags
    if tag != 3:                                           # ES_Descriptor
        return None, b""
    flags = data[pos + 2]
    pos += 3                                               # ES_ID, flags
    if flags & 0x80:                                       # streamDependenceFlag
        pos += 2
    if flags & 0x40:                                       # URL_Flag
        pos += 1 + data[pos]
    if flags & 0x20:                                       # OCRstreamFlag
        pos += 2
    tag, pos, size = _descriptor(data, pos)
    if tag != 4:                                           # DecoderConfigDescriptor
        return None, b""
    oti, end = data[pos], pos + size
    pos += 13                                              # OTI, stream type, buffer, rates
    if pos < end:
        tag, pos, size = _descriptor(data, pos)
        if tag == 5:                                       # DecoderSpecificInfo
            return oti, bytes(data[pos:pos + size])
    return oti, b""


def _boxes(data: bytes, start: int = 0, end: Optional[int] = None):
    """(type, payload start, payload end) of the boxes in ``data[start:end]``."""
    end = len(data) if end is None else end
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        header = 8
        if size == 1:
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            header = 16
        elif size == 0:
            size = end - pos
        if size < header or pos + size > end:
            raise ValueError(f"MP4 box '{kind.decode('latin-1')}' at byte {pos} overruns "
                             f"its parent")
        yield kind, pos + header, pos + size
        pos += size


def _find(data: bytes, path: Sequence[bytes], start: int = 0, end: Optional[int] = None):
    """Payload bounds of the first box at ``path`` below ``data[start:end]``."""
    for kind, s, e in _boxes(data, start, end):
        if kind == path[0]:
            return (s, e) if len(path) == 1 else _find(data, path[1:], s, e)
    return None


def _top_level_moov(f: BinaryIO) -> bytes:
    """The ``moov`` box's payload, read without reading ``mdat``."""
    f.seek(0, 2)
    file_size = f.tell()
    pos = 0
    while pos + 8 <= file_size:
        f.seek(pos)
        size, kind = struct.unpack(">I4s", f.read(8))
        header = 8
        if size == 1:
            size = struct.unpack(">Q", f.read(8))[0]
            header = 16
        elif size == 0:
            size = file_size - pos
        if size < header:
            raise ValueError(f"corrupt MP4: box of size {size} at byte {pos}")
        if kind == b"moov":
            f.seek(pos + header)
            return f.read(size - header)
        pos += size
    raise ValueError("no 'moov' box: not an MP4 / MOV file, or a fragmented one")


def _full_box(data: bytes, start: int) -> Tuple[int, int]:
    """(version, flags) of a full box whose payload starts at ``start``."""
    word = struct.unpack_from(">I", data, start)[0]
    return word >> 24, word & 0xFFFFFF


def _table(data: bytes, bounds, fmt: str, header: int = 8) -> np.ndarray:
    """The entries of a sample table box: ``entry_count`` after the full
    box header, then ``fmt`` (a numpy dtype string) per entry."""
    s, e = bounds
    count = struct.unpack_from(">I", data, s + 4)[0]
    dtype = np.dtype(fmt)
    if s + header + count * dtype.itemsize > e:
        raise ValueError("corrupt MP4 sample table")
    return np.frombuffer(data, dtype, count, s + header)


@dataclass
class VideoTrack:
    """The first video track of an MP4 file."""

    fourcc: bytes
    codec: str                  # H264, MJPEG or MPEG4
    coded_width: int            # the sample entry's width and height
    coded_height: int
    timescale: int
    offsets: np.ndarray         # file offset of each sample, decode order
    sizes: np.ndarray
    dts: np.ndarray             # decode times, media timescale
    cts: np.ndarray             # composition times (dts + ctts)
    sync: np.ndarray            # bool per sample
    matrix: Tuple[int, ...]     # tkhd's nine 16.16 / 2.30 words
    edits: List[Tuple[int, int]] = field(default_factory=list)  # (duration, media_time)
    movie_timescale: int = 1000
    config: bytes = b""         # the avcC or hvcC record, or MPEG-4's DecoderSpecificInfo
    fps: float = 0.0
    has_ctts: bool = False
    dts_shift: int = 0          # FFmpeg's shift that makes dts + ctts >= dts

    @property
    def rotation(self) -> int:
        """OpenCV's ``rotation_angle``: ``-round(av_display_rotation_get)``
        of the display matrix, in [0, 360)."""
        a, b, _, c, d = (x / 65536.0 for x in self.matrix[:5])
        scale0, scale1 = math.hypot(a, c), math.hypot(b, d)
        if scale0 == 0.0 or scale1 == 0.0:
            return 0
        angle = -round(-math.degrees(math.atan2(b / scale1, a / scale0)))
        return angle + 360 if angle < 0 else angle

    def _edit_start(self, media_time: int) -> int:
        """The sample an edit starting at ``media_time`` decodes from:
        FFmpeg's ``find_prev_closest_index``, the last key frame whose dts is
        at or before it (any frame if none is), moved back until its
        composition time is too; 0 if no frame is."""
        target = media_time - self.dts_shift
        for key_only in (True, False):
            index = int(np.searchsorted(self.dts, target, side="right")) - 1
            while key_only and index >= 0 and not self.sync[index]:
                index -= 1
            if index < 0:
                continue
            i = index
            while i > 0 and self.dts[i] == self.dts[i - 1]:
                if not key_only or self.sync[i - 1]:
                    index = i - 1
                i -= 1
            if self.has_ctts:
                while index >= 0 and not (self.cts[index] <= target and self.sync[index]):
                    index -= 1
            if index >= 0:
                return index
        return 0

    def segments(self) -> List[np.ndarray]:
        """The frames a reader returns: for each edit FFmpeg's
        ``mov_fix_index`` plays, the samples (decode indices) it keeps, in
        display order. A sample may appear in more than one edit."""
        order = np.argsort(self.cts, kind="stable")
        if not self.edits:
            return [order]
        n = len(self.dts)
        cts = self.cts + self.dts_shift
        durations = np.append(np.diff(self.dts), 0)
        out = []
        leading = True
        for duration, media_time in self.edits:
            # FFmpeg's av_rescale: the duration in media units, to nearest.
            duration = (2 * duration * self.timescale + self.movie_timescale) // (
                2 * self.movie_timescale)
            if leading and media_time == -1:
                continue                       # a leading empty edit: a delay only
            leading = False
            end = media_time + duration
            kept = []
            waited = False
            for index in range(self._edit_start(media_time), n):
                if media_time <= cts[index] < end:
                    kept.append(index)
                frame_duration = durations[index] if index + 1 < n else duration
                # Stop at the first key frame past the edit; with ctts, at the
                # one after it (B-frames may follow the first).
                if cts[index] + frame_duration >= end and self.sync[index]:
                    if self.has_ctts and not waited:
                        waited = True
                        continue
                    break
            kept = np.asarray(kept, np.int64)
            out.append(kept[np.argsort(self.cts[kept], kind="stable")])
        return out


def read_track(path: str) -> VideoTrack:
    """Parse the first video track of the MP4 / MOV file at ``path``."""
    with open(path, "rb") as f:
        moov = _top_level_moov(f)

    mvhd = _find(moov, [b"mvhd"])
    movie_timescale = 1000
    if mvhd is not None:
        version, _ = _full_box(moov, mvhd[0])
        movie_timescale = struct.unpack_from(">I", moov, mvhd[0] + (20 if version else 12))[0]

    for kind, s, e in _boxes(moov):
        if kind != b"trak":
            continue
        hdlr = _find(moov, [b"mdia", b"hdlr"], s, e)
        if hdlr is None or moov[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        return _parse_trak(moov, s, e, movie_timescale)
    raise ValueError(f"{path} holds no video track")


def _parse_trak(moov: bytes, s: int, e: int, movie_timescale: int) -> VideoTrack:
    tkhd = _find(moov, [b"tkhd"], s, e)
    version, _ = _full_box(moov, tkhd[0])
    matrix = struct.unpack_from(">9i", moov, tkhd[0] + (52 if version else 40))

    edits = []
    elst = _find(moov, [b"edts", b"elst"], s, e)
    if elst is not None:
        version, _ = _full_box(moov, elst[0])
        entries = _table(moov, elst, ">u8,>i8,>i2,>i2" if version else ">u4,>i4,>i2,>i2")
        edits = [(int(d), int(t)) for d, t, _, _ in entries.tolist()]

    mdhd = _find(moov, [b"mdia", b"mdhd"], s, e)
    version, _ = _full_box(moov, mdhd[0])
    timescale = struct.unpack_from(">I", moov, mdhd[0] + (20 if version else 12))[0]

    stbl = _find(moov, [b"mdia", b"minf", b"stbl"], s, e)
    stsd = _find(moov, [b"stsd"], *stbl)
    entry = stsd[0] + 8
    fourcc = moov[entry + 4:entry + 8]
    entry_size = struct.unpack_from(">I", moov, entry)[0]
    children = (entry + 8 + 78, entry + entry_size)     # after the visual sample entry
    config = b""
    if fourcc in _H264_ENTRIES:
        codec = H264
        avcc = _find(moov, [b"avcC"], *children)
        if avcc is None:
            raise ValueError("the H.264 sample entry has no avcC box")
        config = moov[avcc[0]:avcc[1]]
    elif fourcc in _HEVC_ENTRIES:
        codec = HEVC
        hvcc = _find(moov, [b"hvcC"], *children)
        if hvcc is None:
            raise ValueError("the HEVC sample entry has no hvcC box")
        config = moov[hvcc[0]:hvcc[1]]
    elif fourcc in _MJPEG_ENTRIES:
        codec = MJPEG
    elif fourcc == b"mp4v":
        esds = _find(moov, [b"esds"], *children)
        oti, config = esds_decoder_config(moov, esds[0]) if esds is not None else (None, b"")
        if oti not in (JPEG_OTI, MPEG4_PART2_OTI):
            raise _refuse_codec(fourcc, oti)
        codec = MJPEG if oti == JPEG_OTI else MPEG4
    else:
        raise _refuse_codec(fourcc)
    coded_width, coded_height = struct.unpack_from(">HH", moov, entry + 8 + 24)

    durations = _table(moov, _find(moov, [b"stts"], *stbl), ">u4,>u4")
    counts, deltas = durations["f0"].astype(np.int64), durations["f1"].astype(np.int64)
    num_samples = int(counts.sum())
    dts = np.concatenate([[0], np.cumsum(np.repeat(deltas, counts))])[:num_samples]

    cts = dts.copy()
    dts_shift = 0
    ctts = _find(moov, [b"ctts"], *stbl)
    if ctts is not None:
        entries = _table(moov, ctts, ">u4,>i4")
        shifts = entries["f1"].astype(np.int64)
        offsets = np.repeat(shifts, entries["f0"].astype(np.int64))
        cts = dts + offsets[:num_samples]
        # FFmpeg's mov_update_dts_shift, which skips the last two entries.
        dts_shift = max(0, -int(shifts[:-2].min())) if len(shifts) > 2 else 0

    stsz = _find(moov, [b"stsz"], *stbl)
    if stsz is not None:
        size, count = struct.unpack_from(">II", moov, stsz[0] + 4)
        sizes = (np.full(count, size, np.int64) if size else
                 np.frombuffer(moov, ">u4", count, stsz[0] + 12).astype(np.int64))
    else:
        stz2 = _find(moov, [b"stz2"], *stbl)
        field_bits = moov[stz2[0] + 7]
        count = struct.unpack_from(">I", moov, stz2[0] + 8)[0]
        raw = np.frombuffer(moov, np.uint8, -(-count * field_bits // 8), stz2[0] + 12)
        if field_bits == 4:
            sizes = np.stack([raw >> 4, raw & 15], 1).reshape(-1)[:count].astype(np.int64)
        else:
            sizes = np.frombuffer(raw.tobytes(), f">u{field_bits // 8}", count).astype(np.int64)

    chunk_box = _find(moov, [b"stco"], *stbl)
    chunks = (_table(moov, chunk_box, ">u4") if chunk_box is not None else
              _table(moov, _find(moov, [b"co64"], *stbl), ">u8")).astype(np.int64)
    stsc = _table(moov, _find(moov, [b"stsc"], *stbl), ">u4,>u4,>u4")
    first = stsc["f0"].astype(np.int64) - 1
    per_chunk = stsc["f1"].astype(np.int64)
    runs = np.diff(np.append(first, len(chunks)))
    chunk_samples = np.repeat(per_chunk, runs)                  # samples in each chunk
    chunk_of = np.repeat(np.arange(len(chunks)), chunk_samples)[:num_samples]
    chunk_first = np.concatenate([[0], np.cumsum(chunk_samples)])[chunk_of]
    csum = np.concatenate([[0], np.cumsum(sizes)])
    offsets = chunks[chunk_of] + csum[:num_samples] - csum[chunk_first]

    sync = np.ones(num_samples, bool)
    stss = _find(moov, [b"stss"], *stbl)
    if stss is not None and codec != MJPEG:
        sync[:] = False
        sync[_table(moov, stss, ">u4").astype(np.int64) - 1] = True

    total = int(deltas @ counts) if len(counts) else 0
    fps = timescale * num_samples / total if total > 0 and num_samples > 0 else 0.0
    return VideoTrack(fourcc=fourcc, codec=codec, coded_width=coded_width,
                      coded_height=coded_height, timescale=timescale, offsets=offsets,
                      sizes=sizes[:num_samples], dts=dts, cts=cts, sync=sync,
                      matrix=tuple(matrix), edits=edits, movie_timescale=movie_timescale,
                      config=config, fps=fps, has_ctts=ctts is not None, dts_shift=dts_shift)


def parse_avcc(config: bytes) -> Tuple[int, List[bytes], List[bytes]]:
    """(NAL length size, SPS NAL units, PPS NAL units) of an avcC record."""
    if len(config) < 7 or config[0] != 1:
        raise ValueError("corrupt avcC record")
    length_size = (config[4] & 3) + 1
    pos, sets = 5, []
    for mask in (0x1F, 0xFF):
        count = config[pos] & mask
        pos += 1
        units = []
        for _ in range(count):
            n = struct.unpack_from(">H", config, pos)[0]
            units.append(bytes(config[pos + 2:pos + 2 + n]))
            pos += 2 + n
        sets.append(units)
    return length_size, sets[0], sets[1]


def split_nal_units(sample: bytes, length_size: int) -> List[bytes]:
    """The NAL units of a length-prefixed sample."""
    units, pos = [], 0
    while pos + length_size <= len(sample):
        n = int.from_bytes(sample[pos:pos + length_size], "big")
        pos += length_size
        if n == 0 or pos + n > len(sample):
            raise ValueError("corrupt H.264 sample: a NAL unit length past its end")
        units.append(sample[pos:pos + n])
        pos += n
    return units


def annex_b(units: Iterable[bytes]) -> bytes:
    """NAL units as an Annex-B byte stream (4-byte start codes)."""
    return b"".join(START_CODE + unit for unit in units)


# ---------------------------------------------------------------------------
# The muxer.
# ---------------------------------------------------------------------------

def box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def rotation_matrix(rotation: int, width: int, height: int) -> Tuple[int, ...]:
    """The tkhd matrix FFmpeg's muxer writes for a clockwise display
    rotation of 0, 90, 180 or 270 degrees."""
    a, b, c, d, tx, ty = {0: (1, 0, 0, 1, 0, 0), 90: (0, 1, -1, 0, height, 0),
                          180: (-1, 0, 0, -1, width, height),
                          270: (0, -1, 1, 0, 0, width)}[rotation]
    return (a << 16, b << 16, 0, c << 16, d << 16, 0, tx << 16, ty << 16, 1 << 30)


def avc1_entry(width: int, height: int, sps: bytes, pps: bytes) -> bytes:
    """An ``avc1`` visual sample entry with its ``avcC`` record (4-byte NAL
    lengths)."""
    avcc = (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) + struct.pack(">H", len(sps)) + sps
            + bytes([1]) + struct.pack(">H", len(pps)) + pps)
    return visual_entry(b"avc1", width, height, box(b"avcC", avcc))


def _descriptor_bytes(tag: int, *payload: bytes) -> bytes:
    body = b"".join(payload)
    size, groups = len(body), []
    while True:                                    # 7 bits a byte, most significant first
        groups.insert(0, size & 0x7F)
        size >>= 7
        if not size:
            break
    sizes = bytes([g | 0x80 for g in groups[:-1]] + groups[-1:])
    return bytes([tag]) + sizes + body


def mp4v_entry(width: int, height: int, object_type: int, config: bytes = b"") -> bytes:
    """An ``mp4v`` visual sample entry whose ``esds`` names
    ``object_type`` (its DecoderConfigDescriptor's objectTypeIndication)
    and carries ``config`` as its DecoderSpecificInfo (for MPEG-4 Part 2,
    the VOS, VO and VOL headers)."""
    specific = _descriptor_bytes(5, config) if config else b""
    decoder = _descriptor_bytes(4, bytes([object_type, 0x04 << 2 | 1]), bytes(11), specific)
    es = _descriptor_bytes(3, struct.pack(">HB", 1, 0), decoder, _descriptor_bytes(6, b"\x02"))
    return visual_entry(b"mp4v", width, height, full_box(b"esds", 0, 0, es))


def mjpeg_entry(width: int, height: int) -> bytes:
    """The ``mp4v`` entry of JPEG (objectTypeIndication 0x6C): how FFmpeg's
    MP4 muxer, and so cv2's ``MJPG`` writer, stores Motion JPEG."""
    return mp4v_entry(width, height, JPEG_OTI)


def visual_entry(fourcc: bytes, width: int, height: int, *children: bytes) -> bytes:
    return box(fourcc, bytes(6), struct.pack(">H", 1), bytes(16),
               struct.pack(">HHIIIH", width, height, 0x00480000, 0x00480000, 0, 1),
               bytes(32), struct.pack(">Hh", 0x18, -1), *children)


def _table_box(kind: bytes, rows: np.ndarray, version: int = 0) -> bytes:
    return full_box(kind, version, 0, struct.pack(">I", len(rows)), rows.tobytes())


def write_mp4(path: str, sample_entry: bytes, samples: Iterable[bytes], *, width: int,
              height: int, timescale: int, durations: Sequence[int],
              cts_offsets: Optional[Sequence[int]] = None,
              sync: Optional[Sequence[bool]] = None, rotation: int = 0,
              edits: Sequence[Tuple[int, int]] = ()) -> None:
    """Write one video track: ``ftyp``, ``mdat`` (each sample its own
    chunk), then ``moov``. Times are in ``timescale`` units, the movie's
    timescale too; ``edits`` are the ``elst`` entries, each a (segment
    duration, media time) pair, media time -1 for an empty edit."""
    durations = np.asarray(durations, np.int64)
    with open(path, "wb") as f:
        f.write(box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2avc1mp41"))
        mdat_at = f.tell()
        f.write(struct.pack(">I4sQ", 1, b"mdat", 0))
        offsets, sizes = [], []
        for sample in samples:
            offsets.append(f.tell())
            sizes.append(len(sample))
            f.write(sample)
        end = f.tell()
        f.seek(mdat_at + 8)
        f.write(struct.pack(">Q", end - mdat_at))
        f.seek(end)

        n = len(sizes)
        if len(durations) != n:
            raise ValueError(f"{n} samples but {len(durations)} durations")
        total = int(durations.sum())
        matrix = struct.pack(">9i", *rotation_matrix(rotation, width, height))
        stts = np.array([(1, d) for d in durations.tolist()], ">u4")
        tables = [full_box(b"stsd", 0, 0, struct.pack(">I", 1), sample_entry),
                  _table_box(b"stts", stts)]
        if cts_offsets is not None:
            tables.append(_table_box(b"ctts", np.array([(1, c) for c in cts_offsets],
                                                       dtype=[("n", ">u4"), ("c", ">i4")]),
                                     version=1))
        if sync is not None and not all(sync):
            tables.append(_table_box(b"stss", (np.flatnonzero(np.asarray(sync)) + 1)
                                     .astype(">u4")))
        tables += [_table_box(b"stsc", np.array([(1, 1, 1)], ">u4")),
                   full_box(b"stsz", 0, 0, struct.pack(">II", 0, n),
                            np.asarray(sizes, ">u4").tobytes())]
        large = offsets and offsets[-1] >= 1 << 32
        tables.append(_table_box(b"co64" if large else b"stco",
                                 np.asarray(offsets, ">u8" if large else ">u4")))

        track = [full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, total), bytes(8),
                          struct.pack(">hhhH", 0, 0, 0, 0), matrix,
                          struct.pack(">II", width << 16, height << 16))]
        if edits:
            track.append(box(b"edts", full_box(b"elst", 0, 0, struct.pack(">I", len(edits)),
                                               *(struct.pack(">Iihh", d, t, 1, 0)
                                                 for d, t in edits))))
        track.append(box(b"mdia",
                         full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale,
                                                             total, 0x55C4, 0)),
                         full_box(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"Video\x00"),
                         box(b"minf", full_box(b"vmhd", 0, 1, bytes(8)),
                             box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                                   full_box(b"url ", 0, 1))),
                             box(b"stbl", *tables))))
        f.write(box(b"moov",
                    full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, timescale, total),
                             struct.pack(">IH", 0x00010000, 0x0100), bytes(10),
                             struct.pack(">9i", *rotation_matrix(0, 0, 0)), bytes(24),
                             struct.pack(">I", 2)),
                    box(b"trak", *track)))

