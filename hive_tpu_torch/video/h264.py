"""H.264 video (ITU-T H.264), I, P and B slices of the Baseline, Main and
High profiles (CAVLC or CABAC, the 8x8 transform, scaling matrices,
weighted prediction), both ways, as FFmpeg's ``h264`` decoder, and so
``cv2.VideoCapture``, reads it.

**The reader** (:class:`H264Decoder`) parses every sequence and picture
parameter set field and each slice header here (:func:`parse_sps`,
:func:`parse_pps`, :func:`parse_slice_header`, the prediction weight table
among it); it keeps the decoded picture buffer: POC types 0 and 2,
``frame_num`` and its wrap, reference marking by sliding window and by
memory management control operations 1-6 (long-term references included),
the reference lists (P: short-term pictures by descending PicNum; B: list 0
the short-term pictures before the picture by descending POC, then those
after it by ascending POC, list 1 the other way round, its first two
entries swapped where it equals list 0; then long-term ones by ascending
LongTermPicNum; then each list's modification commands), and each
reference picture's macroblock state, which B slices' direct prediction
reads as the co-located picture; and it decodes each slice's macroblocks
in one native call (``native/src/h264_decode.cpp``: CAVLC or CABAC, intra
and inter prediction with spatial and temporal direct modes and default,
explicit or implicit weights, the transforms with the scaling lists this
module resolves), then deblocks the picture in one more. There is no numpy
decoder beside the native one: without a C++ toolchain it raises, naming
the failed build. H.264 decoding is exact by specification, so the planes
equal FFmpeg's bit for bit; what the port copies from FFmpeg is the output
order (:func:`.h264_bits.display_order`: a buffer as deep as the VUI's
``max_num_reorder_frames``, flushed at each IDR picture and at each memory
management control operation 5) and, in temporal direct prediction, the
list 0 index 0 it takes for a co-located reference that list 0 lacks.

Refused by name before any picture is decoded (:func:`scan_track`), naming
the ROADMAP Queue 1 item that will lift it
(:class:`~hive_tpu_torch.video.mp4.UnsupportedVideoError`): fields and
MBAFF (``frame_mbs_only_flag`` 0, 9f-4); and (9f) SP and SI slices; chroma
other than 4:2:0; depths above 8 bits; the lossless transform bypass; POC
type 1; slice groups (FMO); redundant pictures; data partitioning and the
extension NAL units (types 2-4, 20, 21); a gap in ``frame_num``; a change
of picture size within the stream; and POCs whose order the VUI's reorder
depth (absent: 0) cannot put right, where FFmpeg's heuristics would grow
its buffer or drop pictures.

**The writer** (:func:`write_h264_mp4`) makes such files from uint8 4:2:0
planes, for the tests and ``chip_smoke.py``: a planner (:class:`Exerciser`,
seeded choices of every path above, :class:`MotionPlanner`, a motion
field, or :class:`PcmPlanner`, every macroblock I_PCM) decides each
picture's type, slices, marking, reference list commands, direct mode and
weights, and each macroblock's type, transform size, modes, partitions,
lists, references, motion vectors and QP, and may order the pictures
(B pictures after the later pictures they predict from); the native
encoder quantises the true difference to the target planes, with CAVLC or
CABAC (each slice's ``cabac_init_idc``) and the SPS's and PPS's scaling
lists (explicit, default or fallen back). It rebuilds its references with
this module's own decoder, so nothing drifts, and returns counts of each
syntax path it wrote and of each CABAC context it coded.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from hive_tpu_torch.video import mp4
from hive_tpu_torch.video.h264_bits import (LOG2_MAX_POC_LSB, NAL_IDR, NAL_PPS, NAL_SLICE,
                                            NAL_SPS, BitReader, BitWriter, nal_unit, out_of_order,
                                            unescape)
from hive_tpu_torch.video.mp4 import UnsupportedVideoError

P_SLICE, B_SLICE, I_SLICE = 0, 1, 2
SLICE_NAMES = ("P", "B", "I", "SP", "SI")
HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)
# The subset decoded, named in the refusals.
SUBSET = ("I, P and B slices of 8-bit 4:2:0 frame pictures, CAVLC or CABAC (POC types 0 and 2, "
          "the 4x4 and 8x8 transforms, scaling matrices, weighted prediction)")


def _refuse(what: str, item: str = "9f") -> UnsupportedVideoError:
    """The refusal of a feature outside the subset, naming the ROADMAP
    Queue 1 item that will lift it: 9f-4 (fields, MBAFF) or 9f (the
    rest)."""
    return UnsupportedVideoError(
        f"The H.264 video uses {what}; hive_tpu_torch decodes only {SUBSET} (ROADMAP.md "
        f"Queue 1 item {item}).")


def more_rbsp_data(rbsp: bytes, pos: int) -> bool:
    """Whether bits remain before the RBSP's stop bit."""
    last = len(rbsp) - 1
    while last >= 0 and rbsp[last] == 0:
        last -= 1
    if last < 0:
        return False
    byte = rbsp[last]
    return pos < 8 * last + 7 - ((byte & -byte).bit_length() - 1)


# ---------------------------------------------------------------------------
# Parameter sets and slice headers.
# ---------------------------------------------------------------------------

def parse_sps(rbsp: bytes) -> dict:
    """Every field of a sequence parameter set (its NAL header byte first,
    emulation prevention removed), and the derived sizes."""
    r = BitReader(rbsp, 8)
    sps = dict(profile=r.u(8), constraints=r.u(8), level=r.u(8), id=r.ue(), chroma_format=1,
               separate_planes=0, bit_depth=8, bit_depth_chroma=8, transform_bypass=0,
               scaling=None, full_range=False, matrix=2, reorder=None,
               max_dec_frame_buffering=None, vui=False)
    if sps["profile"] in HIGH_PROFILES:
        sps["chroma_format"] = r.ue()
        if sps["chroma_format"] == 3:
            sps["separate_planes"] = r.u(1)
        sps["bit_depth"] = 8 + r.ue()
        sps["bit_depth_chroma"] = 8 + r.ue()
        sps["transform_bypass"] = r.u(1)
        if r.u(1):
            sps["scaling"] = [_read_scaling_list(r, 16 if i < 6 else 64) if r.u(1) else None
                              for i in range(8 if sps["chroma_format"] != 3 else 12)]
    sps["log2_max_frame_num"] = r.ue() + 4
    sps["poc_type"] = r.ue()
    if sps["poc_type"] == 0:
        sps["log2_max_poc_lsb"] = r.ue() + 4
    elif sps["poc_type"] == 1:
        sps["delta_pic_order_always_zero"] = r.u(1)
        sps["offset_for_non_ref_pic"] = r.se()
        sps["offset_for_top_to_bottom_field"] = r.se()
        sps["offset_for_ref_frame"] = [r.se() for _ in range(r.ue())]
    sps["max_num_ref_frames"] = r.ue()
    sps["gaps_allowed"] = r.u(1)
    sps["mbs_w"], map_units_h = r.ue() + 1, r.ue() + 1
    sps["frame_mbs_only"] = r.u(1)
    sps["mbaff"] = 0 if sps["frame_mbs_only"] else r.u(1)
    sps["mbs_h"] = map_units_h * (2 - sps["frame_mbs_only"])
    sps["direct_8x8_inference"] = r.u(1)
    sps["crop"] = (r.ue(), r.ue(), r.ue(), r.ue()) if r.u(1) else (0, 0, 0, 0)
    left, right, top, bottom = sps["crop"]
    sps["width"] = 16 * sps["mbs_w"] - 2 * (left + right)
    sps["height"] = 16 * sps["mbs_h"] - 2 * (2 - sps["frame_mbs_only"]) * (top + bottom)
    if r.u(1):                                     # VUI
        sps["vui"] = True
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
            sps["max_dec_frame_buffering"] = r.ue()
    return sps


# The default scaling lists (Tables 7-3, 7-4) in the order they are coded
# (zig-zag scan index): 4x4 intra, 4x4 inter, 8x8 intra, 8x8 inter.
DEFAULT_4X4 = ((6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42),
               (10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34))
DEFAULT_8X8 = ((6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23, 23, 23, 23, 23,
                23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27, 27, 27, 27, 29, 29, 29, 29,
                29, 29, 29, 31, 31, 31, 31, 31, 31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38,
                38, 40, 40, 42),
               (9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21, 21, 21, 21, 21,
                21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25,
                25, 25, 25, 27, 27, 27, 27, 27, 27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32,
                32, 33, 33, 35))
DEFAULT_LISTS = (DEFAULT_4X4[0],) * 3 + (DEFAULT_4X4[1],) * 3 + DEFAULT_8X8
# The frame zig-zag scans: scan index -> raster position.
ZIGZAG_4X4 = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
ZIGZAG_8X8 = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
              34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
              30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def _read_scaling_list(r: BitReader, size: int):
    """scaling_list() (7.3.2.1.1.1): the list in scan order, or "default"
    (useDefaultScalingMatrixFlag)."""
    last = following = 8
    values = []
    for j in range(size):
        if following:
            following = (last + r.se() + 256) % 256
            if j == 0 and following == 0:
                return "default"
        values.append(following or last)
        last = values[-1]
    return tuple(values)


def _write_scaling_list(w: BitWriter, values) -> None:
    """scaling_list(): "default", or the values in scan order (a run of the
    last value to the end coded by a nextScale of 0)."""
    if values == "default":
        w.se(-8)
        return
    last = 8
    for j, value in enumerate(values):
        if j and all(v == last for v in values[j:]):
            w.se((-last + 128) % 256 - 128)
            return
        w.se((value - last + 128) % 256 - 128)
        last = value


def _fall_back(entries: Sequence, base: Sequence) -> List[Tuple[int, ...]]:
    """The eight lists of a parameter set's entries (None: absent), by
    fall-back rule A (``base`` the default lists) or B (``base`` the
    sequence's lists) of Table 7-2."""
    out: List[Tuple[int, ...]] = []
    for i in range(8):
        entry = entries[i] if i < len(entries) else None
        if entry is None:
            out.append(tuple(base[i]) if i in (0, 3, 6, 7) else out[i - 1])
        else:
            out.append(DEFAULT_LISTS[i] if entry == "default" else tuple(entry))
    return out


def scaling_lists(sps: dict, pps: dict) -> Tuple[np.ndarray, np.ndarray]:
    """The picture's scaling lists in raster order: the six 4x4 lists
    (Intra Y, Cb, Cr, Inter Y, Cb, Cr) and the two 8x8 ones (Intra Y,
    Inter Y); flat 16 where neither parameter set has a matrix."""
    if sps["scaling"] is None:
        lists = [(16,) * 16] * 6 + [(16,) * 64] * 2
    else:
        lists = _fall_back(sps["scaling"], DEFAULT_LISTS)
    if pps.get("scaling") is not None:
        lists = _fall_back(pps["scaling"], DEFAULT_LISTS if sps["scaling"] is None else lists)
    w4 = np.zeros((6, 16), np.int32)
    w8 = np.zeros((2, 64), np.int32)
    for i in range(6):
        w4[i, list(ZIGZAG_4X4)] = lists[i]
    for i in range(2):
        w8[i, list(ZIGZAG_8X8)] = lists[6 + i]
    return w4, w8


def _skip_hrd(r: BitReader) -> None:
    count = r.ue() + 1
    r.u(8)
    for _ in range(count):
        r.ue()
        r.ue()
        r.u(1)
    r.u(20)


def check_sps(sps: dict) -> None:
    """Refuse, by name, a sequence outside the decoded subset."""
    if sps["chroma_format"] != 1:
        raise _refuse(f"chroma format "
                      f"{('4:0:0', '4:2:0', '4:2:2', '4:4:4')[min(sps['chroma_format'], 3)]}")
    if max(sps["bit_depth"], sps["bit_depth_chroma"]) != 8:
        raise _refuse(f"{max(sps['bit_depth'], sps['bit_depth_chroma'])}-bit samples")
    if sps["transform_bypass"]:
        raise _refuse("the lossless transform bypass (qpprime_y_zero_transform_bypass_flag)")
    if sps["poc_type"] == 1:
        raise _refuse("pic_order_cnt_type 1")
    if sps["poc_type"] > 2:
        raise ValueError(f"corrupt H.264 SPS: pic_order_cnt_type {sps['poc_type']}")
    if not sps["frame_mbs_only"]:
        raise _refuse("fields or MBAFF (frame_mbs_only_flag 0)", "9f-4")


def parse_pps(rbsp: bytes) -> dict:
    """Every field of a picture parameter set, its scaling lists as
    :func:`parse_sps` reads them (None: no pic_scaling_matrix_present_flag)."""
    r = BitReader(rbsp, 8)
    pps = dict(id=r.ue(), sps_id=r.ue(), cabac=r.u(1), scaling=None)
    pps["bottom_field_poc"] = r.u(1)
    pps["slice_groups"] = r.ue() + 1
    if pps["slice_groups"] > 1:
        return pps                                 # refused by check_pps
    pps["num_ref_idx_default"] = r.ue() + 1
    pps["num_ref_idx_default_l1"] = r.ue() + 1
    pps["weighted_pred"] = r.u(1)
    pps["weighted_bipred"] = r.u(2)
    pps["init_qp"] = 26 + r.se()
    r.se()                                         # pic_init_qs
    pps["chroma_qp_offset"] = r.se()
    pps["deblocking_control"] = r.u(1)
    pps["constrained_intra"] = r.u(1)
    pps["redundant_pic_cnt"] = r.u(1)
    pps["transform_8x8"] = 0
    pps["second_chroma_qp_offset"] = pps["chroma_qp_offset"]
    if more_rbsp_data(rbsp, r.pos):
        pps["transform_8x8"] = r.u(1)
        if r.u(1):
            pps["scaling"] = [_read_scaling_list(r, 16 if i < 6 else 64) if r.u(1) else None
                              for i in range(6 + 2 * pps["transform_8x8"])]
        pps["second_chroma_qp_offset"] = r.se()
    return pps


def check_pps(pps: dict) -> None:
    if pps["slice_groups"] > 1:
        raise _refuse(f"slice groups (FMO, {pps['slice_groups']} groups)")
    if pps["weighted_bipred"] == 3:
        raise ValueError("corrupt H.264 PPS: weighted_bipred_idc 3")
    if pps["redundant_pic_cnt"]:
        raise _refuse("redundant pictures (redundant_pic_cnt_present_flag 1)")
    if not 0 <= pps["init_qp"] <= 51 or max(abs(pps["chroma_qp_offset"]),
                                             abs(pps["second_chroma_qp_offset"])) > 12:
        raise ValueError("corrupt H.264 PPS: pic_init_qp or chroma_qp_index_offset out of range")


@dataclass
class PredWeights:
    """A slice's pred_weight_table (7.3.3.2): the log2 denominators and, per
    list and reference index, the luma (weight, offset) and the chroma
    ((Cb weight, offset), (Cr weight, offset)), each None where its flag is
    0 (the default weight, no offset)."""

    luma_denom: int = 0
    chroma_denom: int = 0
    lists: List[List[Tuple[Optional[Tuple[int, int]],
                           Optional[Tuple[Tuple[int, int], Tuple[int, int]]]]]] = \
        field(default_factory=lambda: [[], []])

    def table(self) -> np.ndarray:
        """(2, 32, 6) int32: per list and ref_idx the luma weight and offset,
        Cb's and Cr's, defaults where absent."""
        out = np.zeros((2, 32, 6), np.int32)
        out[:, :, 0] = 1 << self.luma_denom
        out[:, :, 2] = out[:, :, 4] = 1 << self.chroma_denom
        for l, entries in enumerate(self.lists):
            for i, (luma, chroma) in enumerate(entries):
                if luma is not None:
                    out[l, i, 0:2] = luma
                if chroma is not None:
                    out[l, i, 2:4], out[l, i, 4:6] = chroma
        return out


@dataclass
class SliceHeader:
    nal_type: int
    ref_idc: int
    first_mb: int = 0
    slice_type: int = I_SLICE
    pps_id: int = 0
    frame_num: int = 0
    idr_pic_id: int = 0
    poc_lsb: int = 0
    delta_poc_bottom: int = 0
    direct_spatial: int = 0
    num_ref_override: Optional[int] = None      # list 0's (with the override flag)
    num_ref_override_l1: Optional[int] = None
    modifications: List[Tuple[int, int]] = field(default_factory=list)
    modifications_l1: List[Tuple[int, int]] = field(default_factory=list)
    weights: Optional[PredWeights] = None
    no_output_of_prior_pics: int = 0
    long_term_reference: int = 0
    mmco: Optional[List[Tuple[int, ...]]] = None   # None: sliding window
    cabac_init_idc: int = 0
    qp_delta: int = 0
    lf_idc: int = 0
    alpha_div2: int = 0
    beta_div2: int = 0
    bit_pos: int = 0

    @property
    def idr(self) -> bool:
        return self.nal_type == NAL_IDR

    def num_ref(self, pps: dict) -> int:
        return self.num_ref_override if self.num_ref_override is not None else \
            pps["num_ref_idx_default"]

    def num_ref_l1(self, pps: dict) -> int:
        return self.num_ref_override_l1 if self.num_ref_override_l1 is not None else \
            pps["num_ref_idx_default_l1"]

    def weighted(self, pps: dict) -> bool:
        """Whether the slice carries a pred_weight_table (explicit weights)."""
        return bool(pps["weighted_pred"]) if self.slice_type == P_SLICE else \
            self.slice_type == B_SLICE and pps["weighted_bipred"] == 1


def _read_modifications(r: BitReader) -> List[Tuple[int, int]]:
    """ref_pic_list_modification() of one list: its commands."""
    commands: List[Tuple[int, int]] = []
    if r.u(1):
        while True:
            idc = r.ue()
            if idc == 3:
                break
            if idc > 2:
                raise ValueError(f"corrupt H.264 slice header: modification_of_pic_nums_idc {idc}")
            commands.append((idc, r.ue()))
            if len(commands) > 33:
                raise ValueError("corrupt H.264 slice header: too many list modifications")
    return commands


def _read_weights(r: BitReader, lists: int, counts: Sequence[int]) -> PredWeights:
    """pred_weight_table() (7.3.3.2) of ``lists`` lists of ``counts`` entries."""
    weights = PredWeights(r.ue(), r.ue(), [[], []])
    if max(weights.luma_denom, weights.chroma_denom) > 7:
        raise ValueError("corrupt H.264 slice header: a log2 weight denominator above 7")
    for l in range(lists):
        for _ in range(counts[l]):
            luma = (r.se(), r.se()) if r.u(1) else None
            chroma = ((r.se(), r.se()), (r.se(), r.se())) if r.u(1) else None
            values = list(luma or ()) + [v for pair in chroma or () for v in pair]
            if any(not -128 <= v <= 127 for v in values):
                raise ValueError("corrupt H.264 slice header: a weight or offset out of range")
            weights.lists[l].append((luma, chroma))
    return weights


def parse_slice_header(rbsp: bytes, sps_table: dict, pps_table: dict) -> SliceHeader:
    """A slice header (7.3.3); refuses, by name, slice types and parameter
    sets outside the subset."""
    r = BitReader(rbsp, 8)
    sh = SliceHeader(nal_type=rbsp[0] & 0x1F, ref_idc=rbsp[0] >> 5)
    sh.first_mb = r.ue()
    slice_type = r.ue()
    if slice_type > 9:
        raise ValueError(f"corrupt H.264 slice header: slice_type {slice_type}")
    sh.slice_type = slice_type % 5
    if sh.slice_type not in (P_SLICE, B_SLICE, I_SLICE):
        raise _refuse(f"{SLICE_NAMES[sh.slice_type]} slices")
    sh.pps_id = r.ue()
    if sh.pps_id not in pps_table:
        raise ValueError(f"an H.264 slice refers to PPS {sh.pps_id}, which the stream lacks")
    pps = pps_table[sh.pps_id]
    check_pps(pps)
    if pps["sps_id"] not in sps_table:
        raise ValueError(f"an H.264 PPS refers to SPS {pps['sps_id']}, which the stream lacks")
    sps = sps_table[pps["sps_id"]]
    check_sps(sps)
    if sh.idr and sh.slice_type != I_SLICE:
        raise ValueError("corrupt H.264 stream: an IDR picture with P or B slices")
    sh.frame_num = r.u(sps["log2_max_frame_num"])
    if sh.idr:
        sh.idr_pic_id = r.ue()
    if sps["poc_type"] == 0:
        sh.poc_lsb = r.u(sps["log2_max_poc_lsb"])
        if pps["bottom_field_poc"]:
            sh.delta_poc_bottom = r.se()
    if sh.slice_type == B_SLICE:
        sh.direct_spatial = r.u(1)
    if sh.slice_type != I_SLICE:
        if r.u(1):
            sh.num_ref_override = r.ue() + 1
            if sh.slice_type == B_SLICE:
                sh.num_ref_override_l1 = r.ue() + 1
        sh.modifications = _read_modifications(r)
        if sh.slice_type == B_SLICE:
            sh.modifications_l1 = _read_modifications(r)
        if not 1 <= sh.num_ref(pps) <= 32 or not 1 <= sh.num_ref_l1(pps) <= 32:
            raise ValueError("corrupt H.264 slice header: num_ref_idx_active out of range")
        if sh.weighted(pps):
            b = sh.slice_type == B_SLICE
            sh.weights = _read_weights(r, 2 if b else 1,
                                       (sh.num_ref(pps), sh.num_ref_l1(pps) if b else 0))
    if sh.ref_idc:
        if sh.idr:
            sh.no_output_of_prior_pics = r.u(1)
            sh.long_term_reference = r.u(1)
        elif r.u(1):
            sh.mmco = []
            while True:
                op = r.ue()
                if op == 0:
                    break
                if op > 6:
                    raise ValueError(f"corrupt H.264 slice header: memory_management_control_"
                                     f"operation {op}")
                args = (r.ue(), r.ue()) if op == 3 else ((r.ue(),) if op != 5 else ())
                sh.mmco.append((op, *args))
                if len(sh.mmco) > 66:
                    raise ValueError("corrupt H.264 slice header: too many marking operations")
    if pps["cabac"] and sh.slice_type != I_SLICE:
        sh.cabac_init_idc = r.ue()
        if sh.cabac_init_idc > 2:
            raise ValueError(f"corrupt H.264 slice header: cabac_init_idc {sh.cabac_init_idc}")
    sh.qp_delta = r.se()
    if not 0 <= pps["init_qp"] + sh.qp_delta <= 51:
        raise ValueError("corrupt H.264 slice header: slice QP out of range")
    if pps["deblocking_control"]:
        sh.lf_idc = r.ue()
        if sh.lf_idc > 2:
            raise ValueError(f"corrupt H.264 slice header: disable_deblocking_filter_idc "
                             f"{sh.lf_idc}")
        if sh.lf_idc != 1:
            sh.alpha_div2, sh.beta_div2 = r.se(), r.se()
            if max(abs(sh.alpha_div2), abs(sh.beta_div2)) > 6:
                raise ValueError("corrupt H.264 slice header: deblocking offset out of range")
    sh.bit_pos = r.pos
    return sh


def _write_modifications(w: BitWriter, commands: Sequence[Tuple[int, int]]) -> None:
    w.u(1, bool(commands))
    if commands:
        for idc, value in commands:
            w.ue(idc).ue(value)
        w.ue(3)


def write_slice_header(sh: SliceHeader, sps: dict, pps: dict) -> BitWriter:
    """The slice header's bits (after the NAL header byte); a slice whose
    PPS asks for a pred_weight_table and that has none writes the default
    one."""
    w = BitWriter().ue(sh.first_mb).ue(sh.slice_type).ue(sh.pps_id)
    w.u(sps["log2_max_frame_num"], sh.frame_num)
    if sh.idr:
        w.ue(sh.idr_pic_id)
    if sps["poc_type"] == 0:
        w.u(sps["log2_max_poc_lsb"], sh.poc_lsb)
    if sh.slice_type == B_SLICE:
        w.u(1, sh.direct_spatial)
    if sh.slice_type != I_SLICE:
        override = sh.num_ref_override is not None or sh.num_ref_override_l1 is not None
        w.u(1, override)
        if override:
            w.ue(sh.num_ref(pps) - 1)
            if sh.slice_type == B_SLICE:
                w.ue(sh.num_ref_l1(pps) - 1)
        _write_modifications(w, sh.modifications)
        if sh.slice_type == B_SLICE:
            _write_modifications(w, sh.modifications_l1)
        if sh.weighted(pps):
            weights = sh.weights or PredWeights()
            w.ue(weights.luma_denom).ue(weights.chroma_denom)
            counts = (sh.num_ref(pps), sh.num_ref_l1(pps))
            for l in range(2 if sh.slice_type == B_SLICE else 1):
                entries = list(weights.lists[l]) + [(None, None)] * counts[l]
                for luma, chroma in entries[:counts[l]]:
                    w.u(1, luma is not None)
                    if luma is not None:
                        w.se(luma[0]).se(luma[1])
                    w.u(1, chroma is not None)
                    if chroma is not None:
                        for weight, offset in chroma:
                            w.se(weight).se(offset)
    if sh.ref_idc:
        if sh.idr:
            w.u(1, sh.no_output_of_prior_pics).u(1, sh.long_term_reference)
        else:
            w.u(1, sh.mmco is not None)
            if sh.mmco is not None:
                for op, *args in sh.mmco:
                    w.ue(op)
                    for a in args:
                        w.ue(a)
                w.ue(0)
    if pps["cabac"] and sh.slice_type != I_SLICE:
        w.ue(sh.cabac_init_idc)
    w.se(sh.qp_delta)
    if pps["deblocking_control"]:
        w.ue(sh.lf_idc)
        if sh.lf_idc != 1:
            w.se(sh.alpha_div2).se(sh.beta_div2)
    return w


def _write_matrix(w: BitWriter, entries: Sequence) -> None:
    """The scaling lists' present flags and lists (None: absent)."""
    for entry in entries:
        w.u(1, entry is not None)
        if entry is not None:
            _write_scaling_list(w, entry)


def encode_sps(width: int, height: int, *, profile: int = 66, poc_type: int = 0,
               num_ref_frames: int = 1, reorder: Optional[int] = None,
               log2_max_frame_num: int = 8, full_range: bool = False,
               matrix: Optional[int] = None, scaling: Optional[Sequence] = None,
               direct_8x8_inference: bool = True) -> bytes:
    """A sequence parameter set: Baseline (constraint set 1: Constrained
    Baseline), Main or High ``profile``, level 5.1, cropped to ``width`` x
    ``height``; ``reorder`` None writes no bitstream restriction;
    ``scaling`` the eight scaling lists of a High profile's
    seq_scaling_matrix (each None: absent, "default", or the values in scan
    order), None for none."""
    if width % 2 or height % 2:
        raise ValueError(f"4:2:0 needs an even frame size, not {width}x{height}")
    if scaling is not None and profile not in HIGH_PROFILES:
        raise ValueError("scaling matrices need a High profile")
    mbs_w, mbs_h = -(-width // 16), -(-height // 16)
    constraints = {66: 0b11000000, 77: 0b01000000}.get(profile, 0)
    w = BitWriter().u(8, profile).u(8, constraints).u(8, 51).ue(0)
    if profile in HIGH_PROFILES:
        w.ue(1).ue(0).ue(0).u(1, 0).u(1, scaling is not None)
        if scaling is not None:
            _write_matrix(w, scaling)
    w.ue(log2_max_frame_num - 4).ue(poc_type)
    if poc_type == 0:
        w.ue(LOG2_MAX_POC_LSB - 4)
    w.ue(num_ref_frames).u(1, 0).ue(mbs_w - 1).ue(mbs_h - 1).u(1, 1).u(1, direct_8x8_inference)
    crop_right, crop_bottom = (16 * mbs_w - width) // 2, (16 * mbs_h - height) // 2
    cropped = bool(crop_right or crop_bottom)
    w.u(1, cropped)
    if cropped:
        w.ue(0).ue(crop_right).ue(0).ue(crop_bottom)
    signal = full_range or matrix is not None
    vui = signal or reorder is not None
    w.u(1, vui)
    if vui:
        w.u(1, 0).u(1, 0).u(1, signal)
        if signal:
            w.u(3, 5).u(1, full_range).u(1, matrix is not None)
            if matrix is not None:
                w.u(8, matrix).u(8, matrix).u(8, matrix)
        w.u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, reorder is not None)
        if reorder is not None:
            w.u(1, 1).ue(0).ue(0).ue(16).ue(16).ue(reorder).ue(max(reorder, num_ref_frames))
    return nal_unit(3, NAL_SPS, np.frombuffer(w.align(True), np.uint8))


def encode_pps(*, num_ref_default: int = 1, num_ref_default_l1: int = 1, init_qp: int = 26,
               chroma_qp_offset: int = 0, second_chroma_qp_offset: Optional[int] = None,
               constrained_intra: bool = False, cabac: bool = False, transform_8x8: bool = False,
               scaling: Optional[Sequence] = None, weighted_pred: bool = False,
               weighted_bipred: int = 0) -> bytes:
    """A picture parameter set: CAVLC or CABAC, one slice group, deblocking
    control present, each list's default reference count, P slices'
    explicit weights (``weighted_pred``) and B slices' weights
    (``weighted_bipred``: 0 default, 1 explicit, 2 implicit); the High
    profile extension, when ``second_chroma_qp_offset``, ``transform_8x8``
    or ``scaling`` (the six or, with the 8x8 transform, eight scaling lists,
    as :func:`encode_sps`'s) asks for it."""
    w = BitWriter().ue(0).ue(0).u(1, cabac).u(1, 0).ue(0).ue(num_ref_default - 1)
    w.ue(num_ref_default_l1 - 1)
    w.u(1, weighted_pred).u(2, weighted_bipred).se(init_qp - 26).se(0).se(chroma_qp_offset).u(1, 1)
    w.u(1, constrained_intra).u(1, 0)
    if second_chroma_qp_offset is not None or transform_8x8 or scaling is not None:
        w.u(1, transform_8x8).u(1, scaling is not None)
        if scaling is not None:
            _write_matrix(w, list(scaling)[:6 + 2 * transform_8x8])
        w.se(chroma_qp_offset if second_chroma_qp_offset is None else second_chroma_qp_offset)
    return nal_unit(3, NAL_PPS, np.frombuffer(w.align(True), np.uint8))


# ---------------------------------------------------------------------------
# The native macroblock layer.
# ---------------------------------------------------------------------------

_STATUS = {-1: "bad arguments", -2: "a slice that runs past its end",
           -3: "an mb_type out of range", -4: "a coded_block_pattern out of range",
           -5: "an mb_qp_delta out of range", -6: "a coeff_token that matches none",
           -7: "a total_zeros that matches none", -8: "a run_before that matches none",
           -9: "a level_prefix too long", -10: "an intra prediction mode needing samples "
           "that are not available", -11: "a ref_idx past the reference list",
           -12: "a sub_mb_type out of range", -13: "macroblocks past the picture's end",
           -14: "a macroblock decoded twice", -15: "an Exp-Golomb code too long",
           -16: "a reference picture that is missing",
           -17: "a CABAC code longer than any value it may hold"}


def _lib():
    from hive_tpu_torch import native

    lib = native.get_native_lib()
    if lib is None:
        raise RuntimeError(f"H.264 video decodes in hive_tpu_torch's native library "
                           f"(native/src/h264_decode.cpp, built with g++), which is not "
                           f"available: {native.build_error()}")
    if lib.hive_h264_param_ints() != PARAM_INTS:
        raise RuntimeError("the native H.264 decoder's slice parameters do not match _params")
    return lib


def _pointers(*arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(*(a.ctypes.data if a is not None else None
                                             for a in arrays))


# What the native encoder counts (its Stat order), then the VLC coverage.
STAT_NAMES = tuple([f"i4x4_mode_{m}" for m in range(9)] + [f"i16x16_mode_{m}" for m in range(4)]
                   + [f"chroma_mode_{m}" for m in range(4)]
                   + ["i_pcm", "p_16x16", "p_16x8", "p_8x16", "p_8x8", "p_8x8ref0"]
                   + [f"sub_{s}" for s in ("8x8", "8x4", "4x8", "4x4")]
                   + ["p_skip", "skip_runs", "intra_in_p", "mb_qp_delta", "mv_outside",
                      "ref_idx_nonzero", "level_prefix_14", "level_prefix_15",
                      "suffix_length_6", "chroma_ac"]
                   + [f"i8x8_mode_{m}" for m in range(9)]
                   + ["transform_8x8_inter", "cavlc_8x8_blocks", "cabac_i_pcm"]
                   + ["b_16x16", "b_16x8", "b_8x16", "b_8x8", "b_direct_16x16", "b_skip"]
                   + [f"b_sub_{t}" for t in range(13)]
                   + ["pred_l0", "pred_l1", "pred_bi", "intra_in_b", "ref_idx_l1_nonzero",
                      "direct_col_intra", "direct_col_list1", "direct_col_zero",
                      "direct_ref_mapped"])
# The coverage counters: coeff_token for nC 0-1, 2-3, 4-7, 8+ and chroma DC
# ([TotalCoeff * 4 + TrailingOnes]), total_zeros of 4x4 blocks and of
# chroma DC ([TotalCoeff - 1][total_zeros]), run_before ([min(zerosLeft,
# 7) - 1][run_before]), and the decisions coded in each CABAC context
# ([table][ctxIdx]: the I slices' table, then cabac_init_idc 0, 1, 2).
COVERAGE_SHAPES = (("coeff_token", (5, 68)), ("total_zeros", (15, 16)),
                   ("chroma_dc_total_zeros", (3, 4)), ("run_before", (7, 15)),
                   ("cabac_contexts", (4, 1024)))
# The int32 a slice's parameters take (``kParamInts`` in h264_decode.cpp).
PARAM_INTS = 17 + 6 * 16 + 2 * 64 + 7 + 4 * 32 + 2 * 32 * 6
PLAN_INTS = 128
(PLAN_I4, PLAN_I16, PLAN_PCM, PLAN_P16, PLAN_P16X8, PLAN_P8X16, PLAN_P8X8, PLAN_P8X8REF0,
 PLAN_SKIP, PLAN_I4_LEVELS, PLAN_DIRECT) = range(11)
# A B partition's lists (plan_record's ``modes``): list 0, list 1, both.
PRED_L0, PRED_L1, PRED_BI = 1, 2, 3


def cabac_contexts_reachable() -> np.ndarray:
    """The (table, ctxIdx) pairs ((4, 1024) bools: the I slices' table, then
    cabac_init_idc 0-2's) that the I, P and B slices of progressive 4:2:0
    pictures can read: mb_type of I slices (3-10) in I slices; mb_skip_flag,
    the P mb_type prefix and suffix, sub_mb_type, the B slices' mb_skip_flag,
    mb_type and sub_mb_type, mvd_lX and ref_idx_lX (11-59) in P and B
    slices; in all, mb_qp_delta, the intra modes, coded_block_pattern,
    coded_block_flag, the significance maps and levels of ctxBlockCat 0-4
    (60-69, 73-275) and the 8x8 transform's flag and blocks in frames
    (399-435). The rest belong to SI, field or 4:4:4 coding."""
    reach = np.zeros((4, 1024), bool)
    for first, end in ((3, 11), (60, 70), (73, 276), (399, 436)):
        reach[0, first:end] = True
    for first, end in ((11, 70), (73, 276), (399, 436)):
        reach[1:, first:end] = True
    return reach


def stat_counts() -> int:
    named = ctypes.c_int32(0)
    total = _lib().hive_h264_stat_counts(ctypes.byref(named))
    if named.value != len(STAT_NAMES):
        raise RuntimeError("the native H.264 encoder's counts do not match STAT_NAMES")
    return total


def coverage(stats: np.ndarray) -> Dict[str, np.ndarray]:
    """The VLC coverage counters of an encoder's counts, by table."""
    out, at = {}, len(STAT_NAMES)
    for name, shape in COVERAGE_SHAPES:
        size = int(np.prod(shape))
        out[name] = stats[at:at + size].reshape(shape)
        at += size
    return out


def _params(sps: dict, pps: dict, weights: np.ndarray, sh: SliceHeader, slice_num: int,
            lists: Sequence[Sequence[Optional["_Ref"]]] = ((), ()), poc: int = 0,
            mb_count: int = 0) -> np.ndarray:
    """The native calls' slice parameters (``Params`` in h264_decode.cpp);
    ``weights`` the pair's scaling lists (:meth:`H264Decoder.weights`),
    ``lists`` the slice's reference lists, ``poc`` the picture's POC."""
    head = np.array([sps["mbs_w"], sps["mbs_h"], slice_num, sh.first_mb, sh.slice_type,
                     pps["init_qp"] + sh.qp_delta, len(lists[0]), pps["chroma_qp_offset"],
                     pps["second_chroma_qp_offset"], pps["constrained_intra"], sh.lf_idc,
                     2 * sh.alpha_div2, 2 * sh.beta_div2, mb_count, pps["cabac"],
                     sh.cabac_init_idc, pps["transform_8x8"]], np.int32)
    b = sh.slice_type == B_SLICE
    mode = 1 if sh.weighted(pps) else (2 if b and pps["weighted_bipred"] == 2 else 0)
    table = sh.weights or PredWeights()
    pocs, long_term = np.zeros((2, 32), np.int32), np.zeros((2, 32), np.int32)
    for l, entries in enumerate(lists):
        for i, entry in enumerate(entries):
            if entry is not None:
                pocs[l, i], long_term[l, i] = entry.poc, entry.long_term is not None
    tail = np.array([len(lists[1]), sh.direct_spatial, sps["direct_8x8_inference"], mode,
                     table.luma_denom if mode == 1 else 0, table.chroma_denom if mode == 1 else 0,
                     poc], np.int32)
    wtab = table.table() if mode == 1 else np.zeros((2, 32, 6), np.int32)
    return np.concatenate([head, weights, tail, pocs.ravel(), long_term.ravel(), wtab.ravel()])


def _int32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# ---------------------------------------------------------------------------
# The decoder.
# ---------------------------------------------------------------------------

@dataclass
class Picture:
    """A decoded picture: its planes cropped to the display size (views of
    the coded ones), and what the output order needs."""

    poc: int
    idr: bool
    reset: bool                 # a memory_management_control_operation 5
    y: Optional[np.ndarray] = None
    u: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None
    sample: int = -1            # the MP4 sample it came from, if the caller says
    slice_types: Tuple[int, ...] = ()

    @property
    def flush(self) -> bool:
        """Whether the output flushes before it (:func:`.h264_bits.display_order`)."""
        return self.idr or self.reset


@dataclass(eq=False)
class _Ref:
    """A reference picture: its planes and macroblock state (the
    co-located motion of B slices' direct prediction), as decoded."""

    id: int
    frame_num: int
    planes: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    long_term: Optional[int] = None     # LongTermFrameIdx
    poc: int = 0
    state: Optional[np.ndarray] = None


class H264Decoder:
    """Decodes access units (lists of NAL units, emulation prevention still
    in) in decode order with :meth:`decode`;
    :func:`.h264_bits.display_order` puts the pictures in display order.
    With ``pixels`` False it reads only the headers and keeps the buffer's
    bookkeeping (:func:`scan_track`)."""

    def __init__(self, pixels: bool = True):
        self.pixels = pixels
        self.sps: Dict[int, dict] = {}
        self.pps: Dict[int, dict] = {}
        self.refs: List[_Ref] = []
        self._weights: Dict[Tuple[int, int], np.ndarray] = {}
        self.max_long_term_idx: Optional[int] = None
        self.prev_poc_msb = self.prev_poc_lsb = 0
        self.prev_frame_num = self.prev_frame_num_offset = 0
        self.prev_ref_frame_num = 0
        self.size: Optional[Tuple[int, int]] = None
        self._ids = 0
        self._started = False

    # -- parameter sets -------------------------------------------------------
    def _parameter_set(self, nal: bytes) -> None:
        rbsp = unescape(nal)
        self._weights.clear()
        if nal[0] & 0x1F == NAL_SPS:
            sps = parse_sps(rbsp)
            check_sps(sps)
            self.sps[sps["id"]] = sps
        else:
            pps = parse_pps(rbsp)
            check_pps(pps)
            self.pps[pps["id"]] = pps

    def weights(self, sps: dict, pps: dict) -> np.ndarray:
        """The (SPS, PPS) pair's scaling lists (:func:`scaling_lists`),
        flattened: resolved once until the next parameter set arrives."""
        key = (sps["id"], pps["id"])
        if key not in self._weights:
            self._weights[key] = np.concatenate([w.ravel() for w in scaling_lists(sps, pps)])
        return self._weights[key]

    # -- access units ---------------------------------------------------------
    def decode(self, nal_units: Iterable[bytes]) -> Optional[Picture]:
        """Decode one access unit; the picture it holds, or None."""
        return self.picture(self.headers(nal_units))

    def headers(self, nal_units: Iterable[bytes]) -> List[Tuple[bytes, SliceHeader]]:
        """Read an access unit's parameter sets and slice headers: its
        slices, each (RBSP, header)."""
        slices = []
        for nal in nal_units:
            nal_type = nal[0] & 0x1F
            if nal_type in (NAL_SPS, NAL_PPS):
                self._parameter_set(nal)
            elif nal_type in (NAL_SLICE, NAL_IDR):
                rbsp = unescape(nal)
                slices.append((rbsp, parse_slice_header(rbsp, self.sps, self.pps)))
            elif nal_type in (2, 3, 4):
                raise _refuse(f"data partitioning (NAL units of type {nal_type})")
            elif nal_type in (20, 21):
                raise _refuse(f"scalable or multiview extensions (NAL units of type {nal_type})")
        return slices

    def picture(self, slices: List[Tuple[bytes, SliceHeader]]) -> Optional[Picture]:
        """Decode the picture of an access unit's slices (:meth:`headers`)."""
        if not slices:
            return None
        first = slices[0][1]
        for _, sh in slices[1:]:
            if (sh.frame_num, sh.idr, sh.poc_lsb, sh.pps_id) != (first.frame_num, first.idr,
                                                               first.poc_lsb, first.pps_id):
                raise ValueError("corrupt H.264 access unit: its slices disagree on the picture")
        pps = self.pps[first.pps_id]
        sps = self.sps[pps["sps_id"]]
        size = (sps["mbs_w"], sps["mbs_h"])
        if self.size is not None and size != self.size:
            raise _refuse(f"a change of picture size within the stream "
                          f"({16 * self.size[0]}x{16 * self.size[1]} to "
                          f"{16 * size[0]}x{16 * size[1]} coded)")
        self.size = size
        if not first.idr and not self._started:
            raise ValueError("an H.264 stream that starts without an IDR picture")
        self._started = True
        if first.idr:
            self.refs = []
        else:
            max_frame_num = 1 << sps["log2_max_frame_num"]
            if first.frame_num not in (self.prev_ref_frame_num,
                                       (self.prev_ref_frame_num + 1) % max_frame_num):
                raise _refuse(f"a gap in frame_num ({self.prev_ref_frame_num} to "
                              f"{first.frame_num})")
        poc = self._poc(first, sps)

        planes = state = None
        if self.pixels:
            mbs_w, mbs_h = size
            planes = (np.empty((16 * mbs_h, 16 * mbs_w), np.uint8),
                      np.empty((8 * mbs_h, 8 * mbs_w), np.uint8),
                      np.empty((8 * mbs_h, 8 * mbs_w), np.uint8))
            lib = _lib()
            state = np.zeros(mbs_w * mbs_h * lib.hive_h264_mb_state_bytes(), np.uint8)
            for number, (rbsp, sh) in enumerate(slices, 1):
                self._decode_slice(lib, rbsp, sh, sps, self.pps[sh.pps_id], number, state,
                                   planes, poc)
            status = lib.hive_h264_deblock(_int32p(np.array(size, np.int32)),
                                           state.ctypes.data, _pointers(*planes))
            if status:
                raise ValueError("corrupt H.264 picture: its slices leave macroblocks "
                                 "undecoded")
        reset = self._mark(first, sps, planes, poc, state)
        if reset:
            poc = 0
        picture = Picture(poc, first.idr, reset, slice_types=tuple(sh.slice_type
                                                                  for _, sh in slices))
        if planes is not None:
            left, right, top, bottom = (2 * c for c in sps["crop"])
            h, w = planes[0].shape
            picture.y = planes[0][top:h - bottom, left:w - right]
            picture.u = planes[1][top // 2:(h - bottom) // 2, left // 2:(w - right) // 2]
            picture.v = planes[2][top // 2:(h - bottom) // 2, left // 2:(w - right) // 2]
        return picture

    def _poc(self, sh: SliceHeader, sps: dict) -> int:
        """PicOrderCnt of the picture (8.2.1), types 0 and 2."""
        max_frame_num = 1 << sps["log2_max_frame_num"]
        if sps["poc_type"] == 0:
            if sh.idr:
                self.prev_poc_msb = self.prev_poc_lsb = 0
            max_lsb = 1 << sps["log2_max_poc_lsb"]
            msb, lsb, prev = self.prev_poc_msb, sh.poc_lsb, self.prev_poc_lsb
            if lsb < prev and prev - lsb >= max_lsb // 2:
                msb += max_lsb
            elif lsb > prev and lsb - prev > max_lsb // 2:
                msb -= max_lsb
            self._msb = msb
            top = msb + lsb
            return min(top, top + sh.delta_poc_bottom)
        if sh.idr:
            offset = 0
        elif self.prev_frame_num > sh.frame_num:
            offset = self.prev_frame_num_offset + max_frame_num
        else:
            offset = self.prev_frame_num_offset
        self._frame_num_offset = offset
        if sh.idr:
            return 0
        return 2 * (offset + sh.frame_num) - (0 if sh.ref_idc else 1)

    # -- reference lists (8.2.4) ------------------------------------------------
    def initial_lists(self, slice_type: int, frame_num: int, poc: int,
                      max_frame_num: int) -> List[List[_Ref]]:
        """The initial reference lists, before truncation and modification
        (8.2.4.2): P's list 0, or B's lists 0 and 1."""
        def pic_num(ref):
            return ref.frame_num - max_frame_num if ref.frame_num > frame_num else ref.frame_num

        shorts = [r for r in self.refs if r.long_term is None]
        longs = sorted((r for r in self.refs if r.long_term is not None), key=lambda r: r.long_term)
        if slice_type == P_SLICE:
            return [sorted(shorts, key=pic_num, reverse=True) + longs]
        before = sorted((r for r in shorts if r.poc <= poc), key=lambda r: r.poc, reverse=True)
        after = sorted((r for r in shorts if r.poc > poc), key=lambda r: r.poc)
        lists = [before + after + longs, after + before + longs]
        if len(lists[1]) > 1 and all(a is b for a, b in zip(*lists)):
            lists[1][0], lists[1][1] = lists[1][1], lists[1][0]
        return lists

    def ref_lists(self, sh: SliceHeader, sps: dict, pps: dict,
                  poc: int) -> List[List[Optional[_Ref]]]:
        """The slice's reference lists (RefPicList0, and RefPicList1 of a B
        slice): the initial lists cut or padded (None) to the active counts,
        then each list's modification commands applied."""
        max_frame_num = 1 << sps["log2_max_frame_num"]

        def pic_num(ref):
            return ref.frame_num - max_frame_num if ref.frame_num > sh.frame_num else ref.frame_num

        shorts = [r for r in self.refs if r.long_term is None]
        longs = [r for r in self.refs if r.long_term is not None]
        out = []
        for l, init in enumerate(self.initial_lists(sh.slice_type, sh.frame_num, poc,
                                                    max_frame_num)):
            n = sh.num_ref_l1(pps) if l else sh.num_ref(pps)
            entries: List[Optional[_Ref]] = (init + [None] * n)[:n]
            pred = sh.frame_num
            for index, (idc, value) in enumerate(sh.modifications_l1 if l else sh.modifications):
                if idc < 2:
                    no_wrap = pred - (value + 1) if idc == 0 else pred + (value + 1)
                    no_wrap %= max_frame_num
                    pred = no_wrap
                    number = no_wrap - max_frame_num if no_wrap > sh.frame_num else no_wrap
                    found = [r for r in shorts if pic_num(r) == number]
                    what = f"short-term picture {number}"
                else:
                    found = [r for r in longs if r.long_term == value]
                    what = f"long-term picture {value}"
                if not found:
                    raise ValueError(f"corrupt H.264 slice: its list modification names the "
                                     f"{what}, which is not a reference")
                entries = (entries[:index] + found + [r for r in entries[index:]
                                                      if r is not found[0]])[:n]
                entries += [None] * (n - len(entries))
            out.append(entries)
        return out

    def _decode_slice(self, lib, rbsp: bytes, sh: SliceHeader, sps: dict, pps: dict,
                      number: int, state: np.ndarray, planes, poc: int) -> None:
        lists = self.ref_lists(sh, sps, pps, poc) if sh.slice_type != I_SLICE else []
        refs, ids = [], []
        for entries in lists:
            for entry in entries:
                refs.extend(entry.planes if entry is not None else (None,) * 3)
                ids.append(entry.id if entry is not None else -1)
        colocated = lists[1][0] if sh.slice_type == B_SLICE else None
        error = ctypes.c_int64(0)
        params = _params(sps, pps, self.weights(sps, pps), sh, number,
                         (lists + [(), ()])[:2], poc)
        status = lib.hive_h264_decode_slice(
            rbsp, len(rbsp), sh.bit_pos, _int32p(params),
            _pointers(*refs) if refs else None,
            _int32p(np.asarray(ids or [0], np.int32)),
            colocated.state.ctypes.data if colocated is not None else None,
            _pointers(*planes), state.ctypes.data, ctypes.byref(error))
        if status:
            raise ValueError(f"corrupt H.264 slice: {_STATUS.get(status, status)} (bit "
                             f"{error.value} of {8 * len(rbsp)})")

    # -- reference marking (8.2.5) ----------------------------------------------
    def _mark(self, sh: SliceHeader, sps: dict, planes, poc: int = 0,
              state: Optional[np.ndarray] = None) -> bool:
        """Mark the decoded picture; whether it held an MMCO 5."""
        max_frame_num = 1 << sps["log2_max_frame_num"]
        reset = False
        if sps["poc_type"] == 2:
            self.prev_frame_num_offset = self._frame_num_offset
            self.prev_frame_num = sh.frame_num
        if not sh.ref_idc:
            return False
        self._ids += 1
        current = _Ref(self._ids, sh.frame_num, planes, poc=poc, state=state)
        if sh.idr:
            self.refs = []
            if sh.long_term_reference:
                current.long_term = 0
                self.max_long_term_idx = 0
            else:
                self.max_long_term_idx = None
        elif sh.mmco is None:
            shorts = [r for r in self.refs if r.long_term is None]
            if len(self.refs) >= max(sps["max_num_ref_frames"], 1) and shorts:
                oldest = min(shorts, key=lambda r: r.frame_num - max_frame_num
                             if r.frame_num > sh.frame_num else r.frame_num)
                self.refs.remove(oldest)
        else:
            for op, *args in sh.mmco:
                if op in (1, 3):
                    number = sh.frame_num - (args[0] + 1)
                    found = [r for r in self.refs if r.long_term is None and
                             (r.frame_num - max_frame_num if r.frame_num > sh.frame_num
                              else r.frame_num) == number]
                    if not found:
                        raise ValueError(f"corrupt H.264 marking: no short-term picture "
                                         f"{number}")
                    if op == 1:
                        self.refs.remove(found[0])
                    else:
                        self.refs = [r for r in self.refs if r.long_term != args[1]]
                        found[0].long_term = args[1]
                elif op == 2:
                    self.refs = [r for r in self.refs if r.long_term != args[0]]
                elif op == 4:
                    self.max_long_term_idx = args[0] - 1 if args[0] else None
                    limit = -1 if self.max_long_term_idx is None else self.max_long_term_idx
                    self.refs = [r for r in self.refs
                                 if r.long_term is None or r.long_term <= limit]
                elif op == 5:
                    self.refs = []
                    self.max_long_term_idx = None
                    reset = True
                elif op == 6:
                    self.refs = [r for r in self.refs if r.long_term != args[0]]
                    current.long_term = args[0]
        if reset:
            current.frame_num = current.poc = 0
            self.prev_frame_num = 0
            self.prev_frame_num_offset = 0
            self.prev_poc_msb = self.prev_poc_lsb = 0
        elif sps["poc_type"] == 0:
            self.prev_poc_msb, self.prev_poc_lsb = self._msb, sh.poc_lsb
        self.prev_ref_frame_num = current.frame_num
        self.refs.append(current)
        if len(self.refs) > max(sps["max_num_ref_frames"], 1):
            raise ValueError(f"corrupt H.264 marking: {len(self.refs)} reference pictures, more "
                             f"than the SPS's {sps['max_num_ref_frames']}")
        return reset


def scan_track(parameter_sets: List[bytes], num_samples: int,
               read: Callable[[int], List[bytes]]) -> Tuple[dict, Optional[int], List[int]]:
    """The stream's first SPS, its reorder depth for
    :func:`.h264_bits.display_order` and the samples that hold IDR pictures,
    after reading every sample's headers in decode order (``read(i)``: the
    NAL units of sample ``i``):
    refuses, before any picture is decoded, what the decoder does not
    decode, frame_num gaps included, and POCs that the reorder depth cannot
    put in order."""
    decoder = H264Decoder(pixels=False)
    for unit in parameter_sets:
        decoder._parameter_set(unit)
    pictures, idr = [], []
    for i in range(num_samples):
        picture = decoder.decode(read(i))
        if picture is not None:
            pictures.append(picture)
            if picture.idr:
                idr.append(i)
    if not decoder.sps:
        raise ValueError("the H.264 stream carries no sequence parameter set")
    sps = next(iter(decoder.sps.values()))
    reorder = sps["reorder"]
    if out_of_order(pictures, reorder):
        raise _refuse("pictures whose POCs the stream's reorder depth ("
                      + ("no bitstream_restriction in the VUI" if reorder is None
                         else f"max_num_reorder_frames {reorder}")
                      + ") does not put in order, where FFmpeg's output heuristics "
                      "would grow its buffer or drop pictures")
    return sps, reorder, idr


# ---------------------------------------------------------------------------
# The writer.
# ---------------------------------------------------------------------------

@dataclass
class SlicePlan:
    first_mb: int
    count: int
    qp_delta: int = 0
    lf_idc: int = 0
    alpha_div2: int = 0
    beta_div2: int = 0
    num_ref: Optional[int] = None               # None: the PPS's default
    modifications: List[Tuple[int, int]] = field(default_factory=list)
    cabac_init_idc: int = 0
    num_ref_l1: Optional[int] = None            # B slices
    modifications_l1: List[Tuple[int, int]] = field(default_factory=list)
    direct_spatial: int = 1
    weights: Optional[PredWeights] = None       # None: the default table, where the PPS asks


@dataclass
class PicturePlan:
    """One picture: its type, marking and slices, and ``mbs``, the native
    encoder's plan record for each macroblock (PLAN_INTS int32); ``levels``
    the luma levels of PLAN_I4_LEVELS macroblocks ((macroblocks, 16, 16):
    4x4 blocks in raster order, each in scan order), which the probes of
    single VLC codewords give instead of quantised ones."""

    slice_type: int
    mbs: np.ndarray
    slices: List[SlicePlan]
    levels: Optional[np.ndarray] = None
    idr: bool = False
    reference: bool = True
    long_term_reference: bool = False
    mmco: Optional[List[Tuple[int, ...]]] = None


@dataclass
class DpbView:
    """What a planner may read of the writer's decoder before a picture:
    its frame_num and the reference pictures, short-term ones by
    descending PicNum (what ref_idx 0, 1, ... name without modification),
    long-term ones as (LongTermFrameIdx, display index); and a B picture's
    initial lists 0 and 1 as display indices."""

    frame_num: int
    max_frame_num: int
    short_terms: List[Tuple[int, int]]          # (PicNum, display index)
    long_terms: List[Tuple[int, int]]
    max_num_ref_frames: int
    b_lists: Tuple[List[int], List[int]] = ((), ())


class GopStructure:
    """The pictures of a clip with B pictures, as x264 codes them: an IDR
    picture every ``gop``, then anchors (P pictures) every ``bframes`` + 1
    pictures and on each GOP's last, the B pictures between two anchors
    coded after the later one; with ``pyramid``, the middle B picture of
    each run of two or more is a reference, coded first."""

    def __init__(self, gop: int, bframes: int, pyramid: bool = False):
        self.gop, self.bframes, self.pyramid = gop, bframes, pyramid

    def role(self, index: int, n: int) -> str:
        """"idr", "anchor", "b_reference" or "b" of display index ``index``."""
        start = index - index % self.gop
        end = min(start + self.gop, n) - 1
        if index == start:
            return "idr"
        if (index - start) % (self.bframes + 1) == 0 or index == end:
            return "anchor"
        before = index - (index - start) % (self.bframes + 1)
        after = min(before + self.bframes + 1, end)
        middle = before + (after - before) // 2
        return "b_reference" if self.pyramid and after - before > 2 and index == middle else "b"

    def decode_order(self, n: int) -> List[int]:
        """Display indices in decode order."""
        order: List[int] = []
        pending: List[int] = []
        for index in range(n):
            role = self.role(index, n)
            if role in ("idr", "anchor"):
                order.append(index)
                order += sorted(pending, key=lambda k: self.role(k, n) != "b_reference")
                pending = []
            else:
                pending.append(index)
        return order + pending


def reorder_depth(order: Sequence[int]) -> int:
    """max_num_reorder_frames of pictures coded in ``order`` (display
    indices): the most pictures that precede one in decode order and follow
    it in display order."""
    return max((sum(j > k for j in order[:i]) for i, k in enumerate(order)), default=0)


def plan_record(kind: int, qp: int, *, i16_mode: int = 2, chroma_mode: int = 0,
                sub: Sequence[int] = (0, 0, 0, 0), refs: Sequence[int] = (0, 0, 0, 0),
                i4_modes: Optional[Sequence[int]] = None,
                mvs: Optional[np.ndarray] = None, t8x8: bool = False,
                modes: Sequence[int] = (PRED_L0, PRED_L0), refs_l1: Sequence[int] = (0, 0, 0, 0),
                mvs_l1: Optional[np.ndarray] = None) -> np.ndarray:
    """One macroblock's plan record (see ``kPlanInts`` in h264_decode.cpp);
    ``t8x8`` asks for the 8x8 transform where the PPS and the macroblock
    allow it (an 8x8 block's intra mode is its first 4x4 block's); in B
    slices, ``modes`` the lists of a 16x16 macroblock or of each 16x8 / 8x16
    partition, ``sub`` B sub_mb_types 0-12, ``refs_l1`` and ``mvs_l1`` list
    1's."""
    rec = np.zeros(PLAN_INTS, np.int32)
    rec[0], rec[1], rec[2], rec[3] = kind, i16_mode, chroma_mode, qp
    rec[4:8], rec[8:12] = sub, refs
    rec[12:28] = 2 if i4_modes is None else i4_modes
    if mvs is not None:
        rec[28:60] = np.broadcast_to(np.asarray(mvs, np.int32), (16, 2)).reshape(-1)
    rec[60] = t8x8
    rec[61:63] = modes
    rec[64:68] = refs_l1
    if mvs_l1 is not None:
        rec[68:100] = np.broadcast_to(np.asarray(mvs_l1, np.int32), (16, 2)).reshape(-1)
    return rec


def random_weights(rng: np.random.Generator, counts: Sequence[int], bipred: bool) -> PredWeights:
    """A seeded pred_weight_table for lists of ``counts`` entries, weights
    within half their default of it, small offsets. B slices' (``bipred``)
    denominators stay below 6: with both weights at most 1.5 x 32 their
    sums stay in the 16 bits that FFmpeg's x86 averaging keeps, which then
    equals 8.4.2.3's."""
    top = 6 if bipred else 8
    weights = PredWeights(int(rng.integers(0, top)), int(rng.integers(0, top)), [[], []])

    def pair(denom):
        span = max(1, (1 << denom) // 2)
        weight = int(np.clip((1 << denom) + rng.integers(-span, span + 1), -128, 127))
        return weight, int(rng.integers(-12, 13))

    for l, count in enumerate(counts):
        for _ in range(count):
            luma = pair(weights.luma_denom) if rng.random() < 0.7 else None
            chroma = (pair(weights.chroma_denom), pair(weights.chroma_denom)) \
                if rng.random() < 0.5 else None
            weights.lists[l].append((luma, chroma))
    return weights


class Exerciser:
    """A seeded planner that writes every path of the decoder: the nine
    4x4, four 16x16 and four chroma modes, I_PCM, every P partition and
    sub-partition, P_Skip runs, intra macroblocks in P slices, 1-4
    reference frames with list modification and long-term references by
    MMCO, a slice a row or several a picture, each
    disable_deblocking_filter_idc with offsets, mb_qp_delta, and motion
    vectors far outside the picture. ``gop``: an IDR picture every that
    many; ``mmco``: the share of reference pictures marked adaptively
    (long-term pictures, MMCO 1-4 and 6; 5 with ``reset``), 0 for none;
    ``t8x8``: the share of macroblocks that ask for the 8x8 transform;
    ``init_idcs``: each slice's cabac_init_idc drawn from these (one value
    is every slice's, and draws nothing). No slice that filters across its
    edges (disable_deblocking_filter_idc 0) follows one that does not
    filter at all (1): it becomes 2, since FFmpeg's frame threads, which
    cv2 runs, report the rows of a slice without deblocking done before
    the slice below filters their last lines, and a later picture may
    predict from them in either state.

    With ``bframes``, pictures follow a :class:`GopStructure` (``pyramid``:
    B references): B pictures of every B macroblock type and sub-type
    (B_Skip, B_Direct_16x16, each partition's list 0, list 1 or both, each
    sub_mb_type, B_Direct_8x8 among them), both lists' counts and
    modifications drawn once a picture (FFmpeg maps a co-located picture's
    references through its last slice's lists), each slice's direct mode
    spatial with probability ``spatial``, and a fifth of the vectors within
    a quarter sample of zero (spatial direct's colZeroFlag); ``b_anchors``:
    the share of P anchors coded as B pictures instead, whose references
    all precede them (list 1 starts as list 0, its first two entries
    swapped). ``weights``: the share of P and B slices with a drawn
    pred_weight_table (where the writer's PPS asks for tables; the others
    write the default one)."""

    def __init__(self, width: int, height: int, seed: int, *, gop: int = 8, qp: int = 28,
                 mmco: float = 0.4, reset: bool = False, t8x8: float = 0.0,
                 init_idcs: Sequence[int] = (0,), bframes: int = 0, pyramid: bool = False,
                 spatial: float = 0.5, weights: float = 0.0, b_anchors: float = 0.0):
        self.mbw, self.mbh = -(-width // 16), -(-height // 16)
        self.rng = np.random.default_rng(seed)
        self.gop, self.qp, self.mmco, self.reset = gop, qp, mmco, reset
        self.t8x8, self.init_idcs = t8x8, tuple(init_idcs)
        self.structure = GopStructure(gop, bframes, pyramid) if bframes else None
        self.spatial, self.weights, self.b_anchors = spatial, weights, b_anchors
        self.count = 0
        self.n = 0

    def decode_order(self, n: int) -> Optional[List[int]]:
        """The order the pictures are coded in (display indices), for
        :func:`write_h264_mp4`; None: display order."""
        self.n = n
        return self.structure.decode_order(n) if self.structure else None

    def _slices(self, n: int) -> List[SlicePlan]:
        rng = self.rng
        layout = rng.integers(0, 3)
        if layout == 0:
            cuts = [0]
        elif layout == 1:                           # a slice a row
            cuts = list(range(0, n, self.mbw))
        else:
            cuts = sorted({0, *rng.integers(1, n, size=min(3, n - 1)).tolist()}) if n > 1 else [0]
        slices = []
        for k, first in enumerate(cuts):
            end = cuts[k + 1] if k + 1 < len(cuts) else n
            lf = int(rng.choice([0, 0, 1, 2]))
            offsets = rng.integers(-6, 7, size=2) if lf != 1 and rng.random() < 0.6 else (0, 0)
            slices.append(SlicePlan(first, end - first, qp_delta=int(rng.integers(-3, 4)),
                                    lf_idc=lf, alpha_div2=int(offsets[0]),
                                    beta_div2=int(offsets[1])))
            slices[-1].cabac_init_idc = (int(rng.choice(self.init_idcs))
                                         if len(self.init_idcs) > 1 else self.init_idcs[0])
        for k, s in enumerate(slices):
            if s.lf_idc == 0 and any(p.lf_idc == 1 for p in slices[:k]):
                s.lf_idc = 2
        return slices

    def __call__(self, index: int, dpb: DpbView) -> PicturePlan:
        if self.structure:
            return self._with_b(index, dpb)
        rng = self.rng
        n = self.mbw * self.mbh
        idr = index % self.gop == 0
        refs_available = len(dpb.short_terms) + len(dpb.long_terms)
        p = not idr and refs_available > 0 and rng.random() < 0.85
        plan = PicturePlan(P_SLICE if p else I_SLICE, np.zeros((n, PLAN_INTS), np.int32),
                           self._slices(n), idr=idr)
        plan.reference = idr or rng.random() < 0.8
        if idr:
            # The first IDR picture long-term, later ones now and then.
            plan.long_term_reference = bool(self.mmco and dpb.max_num_ref_frames >= 3
                                            and (index == 0 or rng.random() < 0.3))
        elif plan.reference and dpb.max_num_ref_frames >= 3 and rng.random() < self.mmco:
            plan.mmco = self._mmco(dpb)
        for s in plan.slices:
            if p:
                most = min(4, refs_available)
                s.num_ref = most if rng.random() < 0.5 else int(rng.integers(1, most + 1))
                if rng.random() < 0.5:
                    s.modifications = self._modifications(dpb, s.num_ref)
                if self.weights and rng.random() < self.weights:
                    s.weights = random_weights(rng, (s.num_ref, 0), False)
        for a in range(n):
            qp = int(np.clip(self.qp + rng.integers(-6, 7), 12, 45)) if rng.random() < 0.3 \
                else self.qp
            s = next(s for s in plan.slices if s.first_mb <= a < s.first_mb + s.count)
            plan.mbs[a] = self._mb(p, qp, s.num_ref or 1)
        return plan

    def _mb(self, p: bool, qp: int, num_ref: int) -> np.ndarray:
        rng = self.rng
        weights = [3, 2, 0.3] + ([3, 1.5, 1.5, 2, 0.7, 2.5] if p else [0] * 6)
        weights = np.array(weights) / sum(weights)
        kind = int(rng.choice(9, p=weights))
        mvs = np.zeros((16, 2), np.int32)
        if kind >= PLAN_P16:
            span = 64 if rng.random() < 0.8 else 4 * 80        # sometimes far outside
            mvs[:] = rng.integers(-span, span + 1, size=2)
            mvs += rng.integers(-6, 7, size=(16, 2))
            mvs[:, 1] = np.clip(mvs[:, 1], -2048, 2047)
        return plan_record(kind, qp, i16_mode=int(rng.integers(0, 4)),
                           chroma_mode=int(rng.integers(0, 4)),
                           sub=rng.integers(0, 4, size=4), refs=rng.integers(0, num_ref, size=4),
                           i4_modes=rng.integers(0, 9, size=16), mvs=mvs,
                           t8x8=bool(self.t8x8 and rng.random() < self.t8x8))

    def _with_b(self, index: int, dpb: DpbView) -> PicturePlan:
        """A picture of a clip with B pictures."""
        rng = self.rng
        n = self.mbw * self.mbh
        role = self.structure.role(index, self.n)
        refs_available = len(dpb.short_terms) + len(dpb.long_terms)
        if role == "idr":
            slice_type = I_SLICE
        elif role == "anchor":
            slice_type = P_SLICE if rng.random() < 0.85 else I_SLICE
            if self.b_anchors and slice_type == P_SLICE and rng.random() < self.b_anchors:
                slice_type = B_SLICE
        else:
            slice_type = B_SLICE
        plan = PicturePlan(slice_type, np.zeros((n, PLAN_INTS), np.int32), self._slices(n),
                           idr=role == "idr", reference=role != "b")
        if role == "idr":
            plan.long_term_reference = bool(self.mmco and dpb.max_num_ref_frames >= 3
                                            and (index == 0 or rng.random() < 0.3))
        elif plan.reference and dpb.max_num_ref_frames >= 3 and rng.random() < self.mmco:
            plan.mmco = self._mmco(dpb)
        counts = [0, 0]
        modifications: List[List[Tuple[int, int]]] = [[], []]
        if slice_type != I_SLICE:
            most = min(4, refs_available)
            for l in range(2 if slice_type == B_SLICE else 1):
                counts[l] = most if rng.random() < 0.5 else int(rng.integers(1, most + 1))
                if rng.random() < 0.4:
                    modifications[l] = self._modifications(dpb, counts[l])
        for s in plan.slices:
            if slice_type != I_SLICE:
                s.num_ref, s.modifications = counts[0], list(modifications[0])
            if slice_type == B_SLICE:
                s.num_ref_l1, s.modifications_l1 = counts[1], list(modifications[1])
                s.direct_spatial = int(rng.random() < self.spatial)
            if slice_type != I_SLICE and rng.random() < self.weights:
                s.weights = random_weights(rng, counts, slice_type == B_SLICE)
        for a in range(n):
            qp = int(np.clip(self.qp + rng.integers(-6, 7), 12, 45)) if rng.random() < 0.3 \
                else self.qp
            plan.mbs[a] = self._mb_b(slice_type, qp, max(1, counts[0]), max(1, counts[1]))
        return plan

    def _mb_b(self, slice_type: int, qp: int, num_ref: int, num_ref_l1: int) -> np.ndarray:
        """A macroblock of a clip with B pictures (in any slice type)."""
        rng = self.rng
        kinds = (PLAN_I4, PLAN_I16, PLAN_PCM, PLAN_P16, PLAN_P16X8, PLAN_P8X16, PLAN_P8X8,
                 PLAN_P8X8REF0, PLAN_SKIP, PLAN_DIRECT)
        if slice_type == B_SLICE:
            weights = [1, 1, 0.2, 3, 1.5, 1.5, 2.5, 0, 2, 2]
        elif slice_type == P_SLICE:
            weights = [1.5, 1, 0.2, 3, 1.5, 1.5, 2, 0.7, 2.5, 0]
        else:
            weights = [3, 2, 0.3, 0, 0, 0, 0, 0, 0, 0]
        kind = kinds[int(rng.choice(len(kinds), p=np.array(weights) / sum(weights)))]
        mvs = []
        for _ in range(2):
            field_ = np.zeros((16, 2), np.int32)
            if rng.random() < 0.2:
                field_[:] = rng.integers(-1, 2, size=2)
            else:
                span = 64 if rng.random() < 0.8 else 4 * 80
                field_[:] = rng.integers(-span, span + 1, size=2)
                field_ += rng.integers(-6, 7, size=(16, 2))
                field_[:, 1] = np.clip(field_[:, 1], -2048, 2047)
            mvs.append(field_)
        return plan_record(kind, qp, i16_mode=int(rng.integers(0, 4)),
                           chroma_mode=int(rng.integers(0, 4)),
                           sub=rng.integers(0, 13 if slice_type == B_SLICE else 4, size=4),
                           refs=rng.integers(0, num_ref, size=4),
                           i4_modes=rng.integers(0, 9, size=16), mvs=mvs[0],
                           t8x8=bool(self.t8x8 and rng.random() < self.t8x8),
                           modes=rng.integers(1, 4, size=2),
                           refs_l1=rng.integers(0, num_ref_l1, size=4), mvs_l1=mvs[1])

    def _modifications(self, dpb: DpbView, num_ref: int) -> List[Tuple[int, int]]:
        """Commands that put a random order of the references first."""
        rng = self.rng
        pool = ([("s", num) for num, _ in dpb.short_terms]
                + [("l", idx) for idx, _ in dpb.long_terms])
        order = [pool[k] for k in rng.permutation(len(pool))][:num_ref]
        commands, pred = [], dpb.frame_num
        for kind, value in order:
            if kind == "l":
                commands.append((2, value))
                continue
            diff = value - pred
            if diff < 0:
                commands.append((0, -diff - 1))
            elif diff > 0:
                commands.append((1, diff - 1))
            else:
                # The same PicNum as the prediction: the long way round.
                commands.append((0, dpb.max_frame_num - 1))
            pred = value
        return commands

    def _mmco(self, dpb: DpbView) -> List[Tuple[int, ...]]:
        """A valid set of marking operations for the picture."""
        rng = self.rng
        ops: List[Tuple[int, ...]] = []
        shorts = list(dpb.short_terms)
        longs = [idx for idx, _ in dpb.long_terms]
        # Set up long-term indices 0-1 once; then turn short-term pictures
        # long-term, drop some, or mark the current picture long-term.
        ops.append((4, 2))
        longs = [idx for idx in longs if idx <= 1]
        # Each operation in turn (3: a long-term picture, 2: one dropped, 5,
        # 1, 6), skipping those the buffer does not allow now.
        cycle = (0, 2, 4, 1, 3) if self.reset else (0, 2, 1, 3)
        while True:
            choice = cycle[self.count % len(cycle)]
            self.count += 1
            if choice == 3 or (choice in (0, 1) and shorts) or (choice == 2 and longs) or \
                    choice == 4:
                break
        if choice == 4:
            return [(5,)]
        if choice == 0:
            num = shorts[int(rng.integers(0, len(shorts)))][0]
            idx = int(rng.integers(0, 2))
            ops.append((3, dpb.frame_num - num - 1, idx))
            shorts = [s for s in shorts if s[0] != num]
            longs = [i for i in longs if i != idx] + [idx]
        elif choice == 1:
            num = shorts[-1][0]
            ops.append((1, dpb.frame_num - num - 1))
            shorts = shorts[:-1]
        elif choice == 2:
            ops.append((2, longs[0]))
            longs = longs[1:]
        else:
            idx = int(rng.integers(0, 2))
            ops.append((6, idx))
            longs = [i for i in longs if i != idx]
            # The current picture takes one place more.
            while len(shorts) + len(longs) + 1 > dpb.max_num_ref_frames and shorts:
                ops.append((1, dpb.frame_num - shorts[-1][0] - 1))
                shorts = shorts[:-1]
            return ops
        while len(shorts) + len(longs) + 1 > dpb.max_num_ref_frames and shorts:
            ops.append((1, dpb.frame_num - shorts[-1][0] - 1))
            shorts = shorts[:-1]
        if len(shorts) + len(longs) + 1 > dpb.max_num_ref_frames:
            ops.append((2, longs[0]))
        return ops


class PcmPlanner:
    """Every macroblock I_PCM, whose raw samples decode exactly (the
    fixture that holds a decoder to known planes), in one I slice a picture
    without deblocking; an IDR picture every ``idr_every`` frames (None:
    the first only)."""

    def __init__(self, width: int, height: int, idr_every: Optional[int] = None):
        self.n = -(-width // 16) * -(-height // 16)
        self.idr_every = idr_every

    def __call__(self, index: int, dpb: DpbView) -> PicturePlan:
        idr = index % self.idr_every == 0 if self.idr_every else index == 0
        return PicturePlan(I_SLICE, np.tile(plan_record(PLAN_PCM, 26), (self.n, 1)),
                           [SlicePlan(0, self.n, lf_idc=1)], idr=idr)


class MotionPlanner:
    """A planner for rendered clips: an IDR picture every ``gop``, its
    macroblocks I_NxN with seeded 4x4 modes (and I_16x16 on every fifth);
    P pictures of P_L0_16x16 macroblocks, ref_idx cycling over up to
    ``refs`` references, each with ``motion(index, ref_index)``'s
    quarter-sample vector ((mbh, mbw, 2), pointing into the display frame
    ``ref_index``); a slice a macroblock row, deblocking on. With
    ``t8x8``, every I_NxN macroblock but every third, and every P one, asks
    for the 8x8 transform (the writer's PPS must allow it).

    With ``bframes``, x264's layout (:class:`GopStructure`, ``pyramid``):
    B pictures whose macroblocks are B_Direct_16x16 on every fourth
    (spatial direct, x264's default) and B_Bi_16x16 on the rest, their (list 0, list 1) reference indices cycling over (0, 0),
    (0, 1), (1, 0) with the motion to each (so implicit weights differ from
    the average); ``p_weights``: each P slice's pred_weight_table gives
    reference r > 0 a luma weight of 64 - r and an offset of r over 2^6."""

    def __init__(self, width: int, height: int, motion: Callable[[int, int], np.ndarray], *,
                 gop: int = 12, qp: int = 24, refs: int = 4, t8x8: bool = False,
                 bframes: int = 0, pyramid: bool = False, p_weights: bool = False):
        self.mbw, self.mbh = -(-width // 16), -(-height // 16)
        self.motion, self.gop, self.qp, self.refs = motion, gop, qp, refs
        self.t8x8 = t8x8
        self.rng = np.random.default_rng(0)
        self.structure = GopStructure(gop, bframes, pyramid) if bframes else None
        self.p_weights = p_weights
        self.n = 0

    def decode_order(self, n: int) -> Optional[List[int]]:
        """As :meth:`Exerciser.decode_order`."""
        self.n = n
        return self.structure.decode_order(n) if self.structure else None

    def __call__(self, index: int, dpb: DpbView) -> PicturePlan:
        n = self.mbw * self.mbh
        slices = [SlicePlan(first, min(self.mbw, n - first)) for first in range(0, n, self.mbw)]
        idr = index % self.gop == 0
        mbs = np.zeros((n, PLAN_INTS), np.int32)
        if idr:
            mbs[:, 0] = PLAN_I4
            mbs[::5, 0] = PLAN_I16
            mbs[:, 1] = self.rng.integers(0, 4, size=n)
            mbs[:, 2] = self.rng.integers(0, 4, size=n)
            mbs[:, 12:28] = self.rng.integers(0, 9, size=(n, 16))
            mbs[:, 3] = self.qp
            if self.t8x8:
                mbs[:, 60] = np.arange(n) % 3 != 0
            return PicturePlan(I_SLICE, mbs, slices, idr=True)
        mbs[:, 3] = self.qp
        mbs[:, 60] = self.t8x8
        role = self.structure.role(index, self.n) if self.structure else "anchor"
        if role != "anchor":
            return self._b_picture(index, dpb, mbs, slices, role)
        available = min(self.refs, len(dpb.short_terms))
        ref = (np.arange(n) % available).astype(np.int32)
        mbs[:, 0] = PLAN_P16
        mbs[:, 8:12] = ref[:, None]
        for r in range(available):
            field_ = np.asarray(self.motion(index, dpb.short_terms[r][1]), np.int32).reshape(n, 2)
            chosen = ref == r
            mbs[chosen, 28:60] = np.tile(field_[chosen], 16)
        for s in slices:
            s.num_ref = available
            if self.p_weights:
                s.weights = PredWeights(6, 6, [[((64 - r, r // 2), None) if r else (None, None)
                                                for r in range(available)], []])
        return PicturePlan(P_SLICE, mbs, slices)

    def _b_picture(self, index: int, dpb: DpbView, mbs: np.ndarray, slices: List[SlicePlan],
                   role: str) -> PicturePlan:
        n = len(mbs)
        counts = [min(2, len(entries)) for entries in dpb.b_lists]
        pairs = np.array([(0, 0), (0, 1), (1, 0)], np.int32)[np.arange(n) % 3]
        pairs = np.minimum(pairs, np.array(counts, np.int32) - 1)
        mbs[:, 0] = PLAN_P16
        mbs[::4, 0] = PLAN_DIRECT
        mbs[:, 61] = PRED_BI
        mbs[:, 8:12] = pairs[:, :1]
        mbs[:, 64:68] = pairs[:, 1:]
        for l, column in ((0, 28), (1, 68)):
            for r in range(counts[l]):
                field_ = np.asarray(self.motion(index, dpb.b_lists[l][r]), np.int32).reshape(n, 2)
                chosen = pairs[:, l] == r
                mbs[chosen, column:column + 32] = np.tile(field_[chosen], 16)
        for s in slices:
            s.num_ref, s.num_ref_l1 = counts
        return PicturePlan(B_SLICE, mbs, slices, reference=role == "b_reference")


def _coded_planes(planes, mbs_w: int, mbs_h: int):
    def pad(p, rows, cols):
        h, w = p.shape
        return np.ascontiguousarray(np.pad(p, ((0, rows - h), (0, cols - w)), mode="edge"))

    y, u, v = planes
    return (pad(y, 16 * mbs_h, 16 * mbs_w), pad(u, 8 * mbs_h, 8 * mbs_w),
            pad(v, 8 * mbs_h, 8 * mbs_w))


def write_h264_mp4(path: str, frames: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                   planner: Callable[[int, DpbView], PicturePlan], *,
                   profile: int = 66, poc_type: int = 0,
                   num_ref_frames: int = 4, reorder: bool = False,
                   restriction: Optional[int] = None, init_qp: int = 26,
                   chroma_qp_offset: int = 0, second_chroma_qp_offset: Optional[int] = None,
                   constrained_intra: bool = False, num_ref_default: int = 1,
                   num_ref_default_l1: int = 1,
                   log2_max_frame_num: int = 8, full_range: bool = False,
                   matrix: Optional[int] = None, fps: Tuple[int, int] = (30, 1),
                   rotation: int = 0, edit_frames: Optional[int] = None,
                   edits: Sequence[Tuple[int, int]] = (), cabac: bool = False,
                   transform_8x8: bool = False, scaling: Optional[dict] = None,
                   weighted_pred: bool = False, weighted_bipred: int = 0,
                   direct_8x8_inference: bool = True) -> dict:
    """Write ``frames`` (uint8 Y, U, V planes in display order, an even
    size; may be lazy) as an H.264 MP4 at ``fps`` = (timescale, frame
    duration), e.g. (30, 1) or (30000, 1001), each picture as
    ``planner(display index, DpbView)`` plans it (:class:`Exerciser`,
    :class:`MotionPlanner`, :class:`PcmPlanner`), in the planner's
    ``decode_order(n)`` where it gives one (B pictures).

    ``reorder``: code the frames 0, 2, 1, 4, 3, ... (the odd ones
    non-reference pictures). Pictures out of display order get ``ctts``, an
    edit list that starts at the first frame, and a
    ``max_num_reorder_frames`` as deep as the order needs (at least
    ``restriction``); otherwise ``restriction``, if given, is the VUI's
    reorder depth. The SPS and PPS options are :func:`encode_sps` and
    :func:`encode_pps`'s: ``cabac`` the entropy coder (each slice's
    cabac_init_idc is its plan's), ``transform_8x8`` the PPS's flag,
    ``scaling`` a dict whose "sps" and "pps" entries, where present, are
    the parameter sets' scaling lists, ``weighted_pred`` and
    ``weighted_bipred`` the weighted prediction (each slice's table is its
    plan's). ``rotation`` is the display matrix's clockwise rotation;
    ``edit_frames`` starts the track's one edit that many frames into the
    media, or ``edits`` gives the edit list itself ((duration, media time)
    in timescale units).
    Returns the counts of :data:`STAT_NAMES` over the file, the VLC
    coverage (``coverage``) and counts of the picture-level paths."""
    height, width = frames[0][0].shape
    n = len(frames)
    mbs_w, mbs_h = -(-width // 16), -(-height // 16)
    order = list(range(n))
    planned = getattr(planner, "decode_order", None)
    planned = planned(n) if planned is not None else None
    if reorder:
        order = [0]
        for k in range(1, n, 2):
            order += [k + 1, k] if k + 1 < n else [k]
    elif planned is not None:
        order = list(planned)
    reordered = order != list(range(n))
    if reordered and poc_type != 0:
        raise ValueError("pictures out of order need POC type 0")
    scaling = scaling or {}
    sps_unit = encode_sps(width, height, profile=profile, poc_type=poc_type,
                          num_ref_frames=num_ref_frames,
                          reorder=max(reorder_depth(order), restriction or 0) if reordered
                          else restriction,
                          log2_max_frame_num=log2_max_frame_num, full_range=full_range,
                          matrix=matrix, scaling=scaling.get("sps"),
                          direct_8x8_inference=direct_8x8_inference)
    pps_unit = encode_pps(num_ref_default=num_ref_default, num_ref_default_l1=num_ref_default_l1,
                          init_qp=init_qp, chroma_qp_offset=chroma_qp_offset,
                          second_chroma_qp_offset=second_chroma_qp_offset,
                          constrained_intra=constrained_intra, cabac=cabac,
                          transform_8x8=transform_8x8, scaling=scaling.get("pps"),
                          weighted_pred=weighted_pred, weighted_bipred=weighted_bipred)
    decoder = H264Decoder()
    decoder.decode([sps_unit, pps_unit])
    sps, pps = decoder.sps[0], decoder.pps[0]
    lib = _lib()
    state_bytes = lib.hive_h264_mb_state_bytes()
    totals = np.zeros(stat_counts(), np.int64)
    counts = dict.fromkeys(("pictures", "idr", "i_pictures", "p_pictures", "non_reference",
                            "slices", "multi_slice_pictures", "lf_idc_0", "lf_idc_1", "lf_idc_2",
                            "lf_offsets", "num_ref_1", "num_ref_2", "num_ref_3", "num_ref_4",
                            "modifications", "long_term_modifications", "long_term_idr",
                            "mmco_1", "mmco_2", "mmco_3", "mmco_4", "mmco_5", "mmco_6",
                            "b_pictures", "b_reference_pictures", "spatial_direct_slices",
                            "temporal_direct_slices", "p_weight_tables", "b_weight_tables",
                            "b_slices_default_weights", "b_slices_explicit_weights",
                            "b_slices_implicit_weights", "l1_modifications",
                            "long_term_in_list1", "list1_swapped"), 0)
    max_frame_num = 1 << log2_max_frame_num
    sync: List[bool] = []
    display_of: Dict[int, int] = {}                 # decoder picture id -> display index
    timescale, duration = fps
    # Decode times are the decode index; composition times the display
    # index, as many frames later as the order needs (ctts stays >= 0).
    delay = max(i - k for i, k in enumerate(order))
    cts_offsets = [(k + delay - i) * duration for i, k in enumerate(order)] if reordered \
        else None
    if edit_frames is not None:
        edits = [((n - edit_frames) * duration, (edit_frames + delay) * duration)]
    elif reordered and not edits:
        edits = [(n * duration, delay * duration)]

    def dpb_view(poc: int) -> DpbView:
        frame_num = 0 if not decoder.refs else (decoder.prev_ref_frame_num + 1) % max_frame_num
        shorts = sorted(((r.frame_num - max_frame_num if r.frame_num > frame_num else r.frame_num,
                          display_of[r.id]) for r in decoder.refs if r.long_term is None),
                        reverse=True)
        longs = sorted((r.long_term, display_of[r.id]) for r in decoder.refs
                       if r.long_term is not None)
        lists = decoder.initial_lists(B_SLICE, frame_num, poc, max_frame_num)
        return DpbView(frame_num, max_frame_num, shorts, longs, num_ref_frames,
                       tuple([display_of[r.id] for r in entries] for entries in lists))

    def samples() -> Iterator[bytes]:
        idr_count, idr_display, previous_reference = 0, 0, True
        for i, k in enumerate(order):
            view = dpb_view(2 * (k - idr_display))
            plan = planner(k, view)
            if i == 0 and not plan.idr:
                raise ValueError("an H.264 stream starts with an IDR picture")
            if reorder and plan.idr and i:
                raise ValueError("pictures out of order are written with one IDR picture, "
                                 "the first")
            if reorder and k % 2 == 1:
                plan.reference, plan.mmco = False, None
            if poc_type == 2 and not previous_reference:
                plan.reference = True              # POC type 2: no two non-reference in a row
            if not plan.reference:
                plan.mmco = None
            previous_reference = plan.reference or plan.idr
            if plan.idr:
                view.frame_num = 0
                idr_display = k
            nal_type = NAL_IDR if plan.idr else NAL_SLICE
            ref_idc = 3 if plan.idr else (2 if plan.reference else 0)
            source = _coded_planes(frames[k], mbs_w, mbs_h)
            plan.mbs = np.ascontiguousarray(plan.mbs, np.int32)
            levels = None if plan.levels is None else np.ascontiguousarray(plan.levels, np.int32)
            recon = tuple(np.zeros_like(p) for p in source)
            state = np.zeros(mbs_w * mbs_h * state_bytes, np.uint8)
            b = plan.slice_type == B_SLICE
            units = []
            for number, s in enumerate(plan.slices, 1):
                sh = SliceHeader(nal_type, ref_idc, first_mb=s.first_mb,
                                 slice_type=plan.slice_type, frame_num=view.frame_num,
                                 idr_pic_id=idr_count % 65536,
                                 poc_lsb=(2 * (k - idr_display)) % (1 << LOG2_MAX_POC_LSB),
                                 direct_spatial=s.direct_spatial if b else 0,
                                 modifications=list(s.modifications),
                                 modifications_l1=list(s.modifications_l1) if b else [],
                                 weights=s.weights,
                                 long_term_reference=int(plan.long_term_reference),
                                 mmco=plan.mmco, qp_delta=s.qp_delta, lf_idc=s.lf_idc,
                                 cabac_init_idc=s.cabac_init_idc,
                                 alpha_div2=s.alpha_div2 if s.lf_idc != 1 else 0,
                                 beta_div2=s.beta_div2 if s.lf_idc != 1 else 0)
                counts_wanted = (s.num_ref or num_ref_default,
                                 s.num_ref_l1 or num_ref_default_l1)
                if plan.slice_type == P_SLICE and counts_wanted[0] != num_ref_default or \
                        b and counts_wanted != (num_ref_default, num_ref_default_l1):
                    sh.num_ref_override = counts_wanted[0]
                    sh.num_ref_override_l1 = counts_wanted[1] if b else None
                poc = decoder._poc(sh, sps)
                lists: List[List[Optional[_Ref]]] = [[], []]
                refs, ids = [], []
                if plan.slice_type != I_SLICE:
                    lists = decoder.ref_lists(sh, sps, pps, poc) + [[]]
                    for entries in lists:
                        for entry in entries:
                            refs.extend(entry.planes)
                            ids.append(entry.id)
                    counts[f"num_ref_{min(len(lists[0]), 4)}"] += 1
                    counts["modifications"] += bool(sh.modifications)
                    counts["long_term_modifications"] += any(idc == 2 for idc, _ in
                                                             sh.modifications)
                    counts["p_weight_tables" if not b else "b_weight_tables"] += \
                        sh.weighted(pps) and s.weights is not None
                if b:
                    counts["spatial_direct_slices" if sh.direct_spatial
                           else "temporal_direct_slices"] += 1
                    counts[("b_slices_default_weights", "b_slices_explicit_weights",
                            "b_slices_implicit_weights")[pps["weighted_bipred"]]] += 1
                    counts["l1_modifications"] += bool(sh.modifications_l1)
                    sides = {r.poc > poc for r in decoder.refs if r.long_term is None}
                    counts["list1_swapped"] += len(decoder.refs) > 1 and len(sides) <= 1
                    counts["long_term_in_list1"] += any(e.long_term is not None for e in lists[1])
                header = write_slice_header(sh, sps, pps)
                prefix = np.packbits(np.array(header.bits + [0] * (-len(header.bits) % 8),
                                              np.uint8)).tobytes()
                params = _params(sps, pps, decoder.weights(sps, pps), sh, number, lists[:2], poc,
                                 s.count)
                capacity = 1024 + 1600 * s.count
                out = np.empty(capacity, np.uint8)
                size = lib.hive_h264_encode_slice(
                    _int32p(params), _pointers(*source), _pointers(*refs) if refs else None,
                    _int32p(np.asarray(ids or [0], np.int32)),
                    lists[1][0].state.ctypes.data if b else None, _pointers(*recon),
                    state.ctypes.data, plan.mbs.ctypes.data,
                    levels.ctypes.data if levels is not None else None,
                    bytes([ref_idc << 5 | nal_type])
                    + prefix, 8 + len(header.bits), out.ctypes.data, capacity,
                    totals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                if size < 0:
                    raise ValueError(f"H.264 slice encode failed: {_STATUS.get(int(size), size)}")
                units.append(bytes([out[0]]) + nal_unit(0, 0, out[1:size])[1:])
                counts[f"lf_idc_{s.lf_idc}"] += 1
                counts["lf_offsets"] += bool(sh.alpha_div2 or sh.beta_div2)
            picture = decoder.decode(units)
            if ref_idc:
                display_of[decoder._ids] = k
            idr_count += plan.idr
            counts["pictures"] += 1
            counts["idr"] += plan.idr
            counts[("p_pictures", "b_pictures", "i_pictures")[plan.slice_type]] += 1
            if b and ref_idc:
                counts["b_reference_pictures"] += 1
            counts["non_reference"] += not ref_idc
            counts["slices"] += len(plan.slices)
            counts["multi_slice_pictures"] += len(plan.slices) > 1
            counts["long_term_idr"] += plan.idr and plan.long_term_reference
            for op, *_ in plan.mmco or ():
                counts[f"mmco_{op}"] += 1
            del picture
            sync.append(plan.idr)
            yield b"".join(len(u).to_bytes(4, "big") + u for u in units)

    mp4.write_mp4(path, mp4.avc1_entry(width, height, sps_unit, pps_unit), samples(),
                  width=width, height=height, timescale=timescale, durations=[duration] * n,
                  cts_offsets=cts_offsets, sync=sync, rotation=rotation, edits=edits)
    result = dict(zip(STAT_NAMES, totals[:len(STAT_NAMES)].tolist()))
    result.update(counts)
    result["coverage"] = coverage(totals)
    return result
