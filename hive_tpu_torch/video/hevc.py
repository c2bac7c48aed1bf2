"""HEVC video (ITU-T H.265), Main profile intra pictures, both ways, as
FFmpeg's ``hevc`` decoder, and so ``cv2.VideoCapture``, reads them.

**The reader** (:class:`HevcDecoder`) parses the two-byte NAL unit header,
every video, sequence and picture parameter set field (``profile_tier_level``,
the short-term reference picture sets, the conformance window in chroma
units, the VUI's range and matrix, its HRD parameters) and each slice
segment header (:func:`parse_vps`, :func:`parse_sps`, :func:`parse_pps`,
:func:`parse_slice_header`); it derives each picture's POC from
``slice_pic_order_cnt_lsb`` and its MSB (8.3.1), and decodes each picture's
slices in one native call (``native/src/hevc_decode.cpp``: the coding
quadtree, intra prediction, residual coding, the transforms, then
deblocking and SAO). There is no numpy decoder beside the native one:
without a C++ toolchain it raises, naming the failed build. HEVC decoding is
exact by specification, so the planes equal FFmpeg's bit for bit; what the
port copies from FFmpeg is the output order
(:func:`.h264_bits.display_order`, shared with H.264: a buffer as deep as
the highest sub-layer's ``sps_max_num_reorder_pics``, flushed at each IDR
picture and at a CRA picture that starts the stream).

Refused by name before any picture is decoded (:func:`scan_track`), naming
the ROADMAP Queue 1 sub-item that will lift it
(:class:`~hive_tpu_torch.video.mp4.UnsupportedVideoError`): P and B slices,
leading, sub-layer switching and BLA pictures and ``pic_output_flag`` 0
(9c-2); scaling lists, tiles, WPP (``entropy_coding_sync_enabled_flag``) and
dependent slice segments, and a conformance window cropping the left side by
other than a multiple of 64 luma samples, which cv2's FFmpeg rescales
(9c-3); depths above 8 bits (Main 10), chroma other
than 4:2:0 and the range and other extensions (9c-4).

**The writer** (:func:`write_hevc_mp4`) makes such files from uint8 4:2:0
planes, for the tests and ``chip_smoke.py``: the parameter sets
(:func:`encode_vps`, :func:`encode_sps`, :func:`encode_pps`) from its
options, each picture's NAL unit type and slices (their QP, SAO, chroma QP
and deblocking fields) and each CTB's SAO parameters from a planner
(:class:`Exerciser`: seeded choices of every path of the decoder;
:class:`IntraPlanner`: a real picture at a fixed QP), and each coding
unit's choices from the planner's knobs, drawn in the native encoder
(seeded) or, for a real picture, the intra mode nearest the target. The
native encoder shares the decoder's prediction and reconstruction, and
counts each path it writes and each CABAC context it codes.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from hive_tpu_torch.video import mp4
from hive_tpu_torch.video.h264_bits import BitReader, BitWriter, escape, out_of_order, unescape
from hive_tpu_torch.video.mp4 import UnsupportedVideoError

# NAL unit types (Table 7-1).
TRAIL_N, TRAIL_R, TSA_N, TSA_R, STSA_N, STSA_R = 0, 1, 2, 3, 4, 5
RADL_N, RADL_R, RASL_N, RASL_R = 6, 7, 8, 9
BLA_W_LP, BLA_W_RADL, BLA_N_LP, IDR_W_RADL, IDR_N_LP, CRA_NUT = 16, 17, 18, 19, 20, 21
VPS_NUT, SPS_NUT, PPS_NUT, AUD_NUT, EOS_NUT, EOB_NUT, FD_NUT = 32, 33, 34, 35, 36, 37, 38
SEI_PREFIX, SEI_SUFFIX = 39, 40
B_SLICE, P_SLICE, I_SLICE = 0, 1, 2
SLICE_NAMES = ("B", "P", "I")
# The subset decoded, named in the refusals.
SUBSET = "Main profile intra pictures (I slices of 8-bit 4:2:0 pictures)"
# ROADMAP Queue 1's sub-items of HEVC.
INTER_ITEM, TOOLS_ITEM, RANGE_ITEM = "9c-2", "9c-3", "9c-4"


def _refuse(what: str, item: str) -> UnsupportedVideoError:
    """The refusal of a feature outside the subset, naming the ROADMAP
    Queue 1 sub-item that will lift it: 9c-2 (inter pictures), 9c-3 (coding
    tools) or 9c-4 (Main 10 and the range extensions)."""
    return UnsupportedVideoError(
        f"The HEVC video uses {what}; hive_tpu_torch decodes only {SUBSET} so far (ROADMAP.md "
        f"Queue 1 item {item}).")


def nal_type(nal: bytes) -> int:
    """nal_unit_type of a NAL unit (its two-byte header first)."""
    if len(nal) < 2 or nal[0] & 0x80:
        raise ValueError("corrupt HEVC NAL unit header")
    return (nal[0] >> 1) & 0x3F


def _rbsp(nal: bytes) -> bytes:
    return unescape(nal)


# ---------------------------------------------------------------------------
# Parameter sets.
# ---------------------------------------------------------------------------

def _profile_tier_level(r: BitReader, max_sub_layers_minus1: int) -> dict:
    ptl = dict(profile_space=r.u(2), tier=r.u(1), profile=r.u(5), compatibility=r.u(32),
               progressive=r.u(1), interlaced=r.u(1), non_packed=r.u(1), frame_only=r.u(1))
    ptl["constraints"] = r.u(44)                  # 43 constraint bits and one reserved
    ptl["level"] = r.u(8)
    present = [(r.u(1), r.u(1)) for _ in range(max_sub_layers_minus1)]
    if max_sub_layers_minus1:
        for _ in range(max_sub_layers_minus1, 8):
            r.u(2)
    for profile_present, level_present in present:
        if profile_present:
            r.u(32)
            r.u(32)
            r.u(24)
        if level_present:
            r.u(8)
    return ptl


def parse_vps(rbsp: bytes) -> dict:
    """The fields of a video parameter set the decoder reads (its NAL header
    first, emulation prevention removed)."""
    r = BitReader(rbsp, 16)
    vps = dict(id=r.u(4))
    r.u(2)
    vps["max_layers"] = r.u(6) + 1
    vps["max_sub_layers"] = r.u(3) + 1
    r.u(17)                                        # temporal_id_nesting, reserved 0xFFFF
    vps["ptl"] = _profile_tier_level(r, vps["max_sub_layers"] - 1)
    return vps


def _sub_layer_hrd(r: BitReader, count: int, sub_pic: int) -> None:
    for _ in range(count):
        r.ue()
        r.ue()
        if sub_pic:
            r.ue()
            r.ue()
        r.u(1)


def _hrd_parameters(r: BitReader, common: bool, max_sub_layers_minus1: int) -> None:
    nal = vcl = sub_pic = 0
    if common:
        nal, vcl = r.u(1), r.u(1)
        if nal or vcl:
            sub_pic = r.u(1)
            if sub_pic:
                r.u(8 + 5 + 1 + 5)
            r.u(8)                                 # bit_rate_scale, cpb_size_scale
            if sub_pic:
                r.u(4)
            r.u(15)
    for _ in range(max_sub_layers_minus1 + 1):
        fixed_general = r.u(1)
        fixed_cvs = 1 if fixed_general else r.u(1)
        low_delay = 0
        if fixed_cvs:
            r.ue()
        else:
            low_delay = r.u(1)
        count = 1 if low_delay else r.ue() + 1
        for present in (nal, vcl):
            if present:
                _sub_layer_hrd(r, count, sub_pic)


def _st_ref_pic_set(r: BitReader, idx: int, sets: List[Tuple[int, ...]]) -> Tuple[int, ...]:
    """One st_ref_pic_set (7.3.7): its delta POCs (negative ones first, as
    the standard orders them)."""
    if idx and r.u(1):                             # inter_ref_pic_set_prediction_flag
        delta_idx = r.ue() + 1 if idx == len(sets) else 1
        ref = sets[idx - delta_idx]
        sign, magnitude = r.u(1), r.ue() + 1
        delta_rps = -magnitude if sign else magnitude
        deltas = []
        for j in range(len(ref) + 1):
            used = r.u(1)
            if used or r.u(1):
                deltas.append((ref[j] if j < len(ref) else 0) + delta_rps)
        negative = sorted((d for d in deltas if d < 0), reverse=True)
        positive = sorted(d for d in deltas if d > 0)
        return tuple(negative + positive)
    num_negative, num_positive = r.ue(), r.ue()
    deltas, poc = [], 0
    for _ in range(num_negative):
        poc -= r.ue() + 1
        r.u(1)
        deltas.append(poc)
    poc = 0
    for _ in range(num_positive):
        poc += r.ue() + 1
        r.u(1)
        deltas.append(poc)
    return tuple(deltas)


def parse_sps(rbsp: bytes) -> dict:
    """Every field of a sequence parameter set the decoder, the refusals
    and the output order read (its NAL header first, emulation prevention
    removed), and the derived sizes."""
    r = BitReader(rbsp, 16)
    sps = dict(vps_id=r.u(4), max_sub_layers=r.u(3) + 1)
    r.u(1)
    sps["ptl"] = _profile_tier_level(r, sps["max_sub_layers"] - 1)
    sps["id"] = r.ue()
    sps["chroma_format"] = r.ue()
    sps["separate_planes"] = r.u(1) if sps["chroma_format"] == 3 else 0
    sps["coded_width"], sps["coded_height"] = r.ue(), r.ue()
    sps["window"] = (r.ue(), r.ue(), r.ue(), r.ue()) if r.u(1) else (0, 0, 0, 0)
    sps["bit_depth"], sps["bit_depth_chroma"] = 8 + r.ue(), 8 + r.ue()
    sps["log2_max_poc_lsb"] = r.ue() + 4
    ordering = r.u(1)
    layers = []
    for _ in range(0 if ordering else sps["max_sub_layers"] - 1, sps["max_sub_layers"]):
        layers.append((r.ue() + 1, r.ue(), r.ue()))
    sps["max_dec_pic_buffering"], sps["reorder"], _ = layers[-1]
    sps["min_cb_log2"] = r.ue() + 3
    sps["ctb_log2"] = sps["min_cb_log2"] + r.ue()
    sps["min_tb_log2"] = r.ue() + 2
    sps["max_tb_log2"] = sps["min_tb_log2"] + r.ue()
    sps["max_depth_inter"], sps["max_depth_intra"] = r.ue(), r.ue()
    sps["scaling_list"] = r.u(1)
    if sps["scaling_list"] and r.u(1):
        return sps                                 # refused by check_sps (9c-3)
    sps["amp"], sps["sao"], sps["pcm"] = r.u(1), r.u(1), r.u(1)
    if sps["pcm"]:
        sps["pcm_bits"] = (r.u(4) + 1, r.u(4) + 1)
        sps["pcm_min_log2"] = r.ue() + 3
        sps["pcm_max_log2"] = sps["pcm_min_log2"] + r.ue()
        sps["pcm_no_filter"] = r.u(1)
    sets: List[Tuple[int, ...]] = []
    for i in range(r.ue()):
        sets.append(_st_ref_pic_set(r, i, sets))
    sps["st_rps"] = sets
    sps["long_term"] = r.u(1)
    sps["num_long_term_sps"] = 0
    if sps["long_term"]:
        sps["num_long_term_sps"] = r.ue()
        for _ in range(sps["num_long_term_sps"]):
            r.u(sps["log2_max_poc_lsb"] + 1)
    sps["temporal_mvp"], sps["strong_smoothing"] = r.u(1), r.u(1)
    sps.update(full_range=False, matrix=2, vui=False)
    if r.u(1):
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
        r.u(3)                                     # neutral chroma, field_seq, frame_field_info
        if r.u(1):                                 # default display window (ignored by FFmpeg)
            for _ in range(4):
                r.ue()
        if r.u(1):                                 # timing
            r.u(64)
            if r.u(1):
                r.ue()
            if r.u(1):
                _hrd_parameters(r, True, sps["max_sub_layers"] - 1)
        if r.u(1):                                 # bitstream restriction
            r.u(3)
            for _ in range(5):
                r.ue()
    sps["extensions"] = r.u(1) and r.u(8)          # range, multilayer, 3D, SCC, 4 bits
    sub_w = 2 if sps["chroma_format"] in (1, 2) else 1
    sub_h = 2 if sps["chroma_format"] == 1 else 1
    left, right, top, bottom = sps["window"]
    sps["crop"] = (sub_w * left, sub_w * right, sub_h * top, sub_h * bottom)
    sps["width"] = sps["coded_width"] - sps["crop"][0] - sps["crop"][1]
    sps["height"] = sps["coded_height"] - sub_h * (top + bottom)
    ctb = 1 << sps["ctb_log2"]
    sps["ctbs_w"] = -(-sps["coded_width"] // ctb)
    sps["ctbs_h"] = -(-sps["coded_height"] // ctb)
    return sps


def check_sps(sps: dict) -> None:
    """Refuse, by name, a sequence outside the decoded subset."""
    if sps["chroma_format"] != 1:
        raise _refuse(f"chroma format "
                      f"{('4:0:0', '4:2:0', '4:2:2', '4:4:4')[min(sps['chroma_format'], 3)]}",
                      RANGE_ITEM)
    if max(sps["bit_depth"], sps["bit_depth_chroma"]) != 8:
        raise _refuse(f"{max(sps['bit_depth'], sps['bit_depth_chroma'])}-bit samples (Main 10 "
                      f"or a range extension profile)", RANGE_ITEM)
    if sps["scaling_list"]:
        raise _refuse("scaling lists (scaling_list_enabled_flag)", TOOLS_ITEM)
    if sps["extensions"]:
        raise _refuse("SPS extensions (the range, multilayer, 3D or SCC extension)", RANGE_ITEM)
    if not (3 <= sps["min_cb_log2"] <= sps["ctb_log2"] <= 6 and 2 <= sps["min_tb_log2"]
            < sps["min_cb_log2"] and sps["max_tb_log2"] <= min(sps["ctb_log2"], 5)):
        raise ValueError("corrupt HEVC SPS: coding or transform block sizes out of range")
    if sps["crop"][0] % 64:
        raise _refuse(f"a conformance window that crops {sps['crop'][0]} luma columns on the "
                      f"left, not a multiple of 64, where cv2's FFmpeg keeps its rows aligned "
                      f"and rescales the frame", TOOLS_ITEM)
    if sps["coded_width"] % (1 << sps["min_cb_log2"]) or \
            sps["coded_height"] % (1 << sps["min_cb_log2"]) or sps["width"] <= 0 or \
            sps["height"] <= 0:
        raise ValueError("corrupt HEVC SPS: a picture size that is not a multiple of the "
                         "smallest coding block, or a window larger than the picture")


def parse_pps(rbsp: bytes) -> dict:
    """Every field of a picture parameter set the decoder and the refusals
    read."""
    r = BitReader(rbsp, 16)
    pps = dict(id=r.ue(), sps_id=r.ue(), dependent_slices=r.u(1), output_flag=r.u(1),
               extra_bits=r.u(3), sign_hiding=r.u(1), cabac_init_present=r.u(1))
    r.ue()
    r.ue()                                         # num_ref_idx_lX_default_active
    pps["init_qp"] = 26 + r.se()
    pps["constrained_intra"], pps["transform_skip"] = r.u(1), r.u(1)
    pps["cu_qp_delta"] = r.u(1)
    pps["cu_qp_delta_depth"] = r.ue() if pps["cu_qp_delta"] else 0
    pps["cb_qp_offset"], pps["cr_qp_offset"] = r.se(), r.se()
    pps["slice_chroma_offsets"] = r.u(1)
    pps["weighted_pred"], pps["weighted_bipred"] = r.u(1), r.u(1)
    pps["transquant_bypass"], pps["tiles"], pps["wpp"] = r.u(1), r.u(1), r.u(1)
    if pps["tiles"]:
        return pps                                 # refused by check_pps (9c-3)
    pps["across_slices"] = r.u(1)
    pps["deblocking_override"] = pps["deblocking_off"] = pps["beta_div2"] = pps["tc_div2"] = 0
    if r.u(1):                                     # deblocking_filter_control_present_flag
        pps["deblocking_override"], pps["deblocking_off"] = r.u(1), r.u(1)
        if not pps["deblocking_off"]:
            pps["beta_div2"], pps["tc_div2"] = r.se(), r.se()
    pps["scaling_list"] = r.u(1)
    if pps["scaling_list"]:
        return pps                                 # refused by check_pps (9c-3)
    pps["lists_modification"] = r.u(1)
    r.ue()                                         # log2_parallel_merge_level
    pps["header_extension"] = r.u(1)
    pps["extensions"] = r.u(1) and r.u(8)
    return pps


def check_pps(pps: dict) -> None:
    if pps["tiles"]:
        raise _refuse("tiles (tiles_enabled_flag)", TOOLS_ITEM)
    if pps["wpp"]:
        raise _refuse("wavefront parallel processing (entropy_coding_sync_enabled_flag)",
                      TOOLS_ITEM)
    if pps["scaling_list"]:
        raise _refuse("scaling lists (pps_scaling_list_data_present_flag)", TOOLS_ITEM)
    if pps["extensions"]:
        raise _refuse("PPS extensions (the range, multilayer, 3D or SCC extension)", RANGE_ITEM)
    if not -26 <= pps["init_qp"] - 26 <= 25 or max(abs(pps["cb_qp_offset"]),
                                                    abs(pps["cr_qp_offset"])) > 12:
        raise ValueError("corrupt HEVC PPS: init_qp_minus26 or a chroma QP offset out of "
                         "range")


# ---------------------------------------------------------------------------
# Slice segment headers.
# ---------------------------------------------------------------------------

@dataclass
class SliceHeader:
    nal_type: int
    first: bool = True
    pps_id: int = 0
    address: int = 0
    dependent: bool = False
    slice_type: int = I_SLICE
    pic_output: bool = True
    poc_lsb: int = 0
    sao_luma: bool = False
    sao_chroma: bool = False
    qp_delta: int = 0
    cb_offset: int = 0
    cr_offset: int = 0
    deblocking_override: bool = False
    deblocking_off: bool = False
    beta_div2: int = 0
    tc_div2: int = 0
    across: bool = False
    data_offset: int = 0            # the byte of the RBSP where slice data starts
    temporal_id: int = 0

    @property
    def irap(self) -> bool:
        return BLA_W_LP <= self.nal_type <= 23

    @property
    def idr(self) -> bool:
        return self.nal_type in (IDR_W_RADL, IDR_N_LP)


def _bits_for(count: int) -> int:
    """Ceil(Log2(count))."""
    return max(0, (count - 1).bit_length())


def check_nal_type(kind: int) -> None:
    if kind in (RADL_N, RADL_R, RASL_N, RASL_R):
        raise _refuse(f"leading pictures (NAL unit type {kind}, RADL / RASL)", INTER_ITEM)
    if kind in (TSA_N, TSA_R, STSA_N, STSA_R):
        raise _refuse(f"temporal sub-layer access pictures (NAL unit type {kind})", INTER_ITEM)
    if kind in (BLA_W_LP, BLA_W_RADL, BLA_N_LP):
        raise _refuse(f"broken link access pictures (NAL unit type {kind})", INTER_ITEM)
    if 10 <= kind <= 15 or 22 <= kind <= 31:
        raise ValueError(f"corrupt HEVC stream: reserved VCL NAL unit type {kind}")


def parse_slice_header(rbsp: bytes, sps_table: dict, pps_table: dict) -> SliceHeader:
    """A slice segment header (7.3.6), its NAL header first; refuses what
    the decoder does not decode."""
    kind = nal_type(rbsp)
    check_nal_type(kind)
    r = BitReader(rbsp, 16)
    sh = SliceHeader(kind, temporal_id=(rbsp[1] & 7) - 1)
    sh.first = bool(r.u(1))
    if BLA_W_LP <= kind <= 23:
        r.u(1)                                     # no_output_of_prior_pics_flag
    sh.pps_id = r.ue()
    if sh.pps_id not in pps_table:
        raise ValueError(f"an HEVC slice names PPS {sh.pps_id}, which the stream does not carry")
    pps = pps_table[sh.pps_id]
    if pps["sps_id"] not in sps_table:
        raise ValueError(f"an HEVC PPS names SPS {pps['sps_id']}, which the stream does not "
                         f"carry")
    sps = sps_table[pps["sps_id"]]
    if not sh.first:
        if pps["dependent_slices"]:
            sh.dependent = bool(r.u(1))
        sh.address = r.u(_bits_for(sps["ctbs_w"] * sps["ctbs_h"]))
    if sh.dependent:
        raise _refuse("dependent slice segments (dependent_slice_segment_flag)", TOOLS_ITEM)
    r.u(pps["extra_bits"])
    sh.slice_type = r.ue()
    if sh.slice_type in (P_SLICE, B_SLICE):
        raise _refuse(f"{SLICE_NAMES[sh.slice_type]} slices", INTER_ITEM)
    if sh.slice_type != I_SLICE:
        raise ValueError(f"corrupt HEVC slice header: slice_type {sh.slice_type}")
    if pps["output_flag"]:
        sh.pic_output = bool(r.u(1))
        if not sh.pic_output:
            raise _refuse("pictures not for output (pic_output_flag 0)", INTER_ITEM)
    if not sh.idr:
        sh.poc_lsb = r.u(sps["log2_max_poc_lsb"])
        if not r.u(1):                             # short_term_ref_pic_set_sps_flag
            _st_ref_pic_set(r, len(sps["st_rps"]), sps["st_rps"])
        elif len(sps["st_rps"]) > 1:
            r.u(_bits_for(len(sps["st_rps"])))
        if sps["long_term"]:
            num_sps = r.ue() if sps["num_long_term_sps"] else 0
            num_pics = r.ue()
            for i in range(num_sps + num_pics):
                if i < num_sps:
                    if sps["num_long_term_sps"] > 1:
                        r.u(_bits_for(sps["num_long_term_sps"]))
                else:
                    r.u(sps["log2_max_poc_lsb"] + 1)
                if r.u(1):
                    r.ue()
        if sps["temporal_mvp"]:
            r.u(1)
    if sps["sao"]:
        sh.sao_luma, sh.sao_chroma = bool(r.u(1)), bool(r.u(1))
    sh.qp_delta = r.se()
    if pps["slice_chroma_offsets"]:
        sh.cb_offset, sh.cr_offset = r.se(), r.se()
    sh.deblocking_off = bool(pps["deblocking_off"])
    sh.beta_div2, sh.tc_div2 = pps["beta_div2"], pps["tc_div2"]
    if pps["deblocking_override"]:
        sh.deblocking_override = bool(r.u(1))
    if sh.deblocking_override:
        sh.deblocking_off = bool(r.u(1))
        sh.beta_div2, sh.tc_div2 = (0, 0) if sh.deblocking_off else (r.se(), r.se())
    sh.across = bool(pps["across_slices"])
    if pps["across_slices"] and (sh.sao_luma or sh.sao_chroma or not sh.deblocking_off):
        sh.across = bool(r.u(1))
    if pps["header_extension"]:
        r.pos += 8 * r.ue()
    if r.u(1) != 1:
        raise ValueError("corrupt HEVC slice header: no alignment_bit_equal_to_one")
    sh.data_offset = r.byte_aligned()
    qp = pps["init_qp"] + sh.qp_delta
    if not 0 <= qp <= 51 or max(abs(sh.cb_offset), abs(sh.cr_offset),
                                abs(pps["cb_qp_offset"] + sh.cb_offset),
                                abs(pps["cr_qp_offset"] + sh.cr_offset)) > 12:
        raise ValueError("corrupt HEVC slice header: SliceQpY or a chroma QP offset out of range")
    if sh.data_offset >= len(rbsp):
        raise ValueError("corrupt HEVC slice: no slice data")
    return sh


def write_slice_header(sh: SliceHeader, sps: dict, pps: dict) -> bytes:
    """The NAL unit header and slice segment header of an I slice, through
    byte_alignment(), as bytes (no emulation prevention yet). Another
    ``slice_type`` writes only the fields up to it correctly (refusal
    fixtures: :func:`with_slice_type`)."""
    w = BitWriter().u(1, 0).u(6, sh.nal_type).u(6, 0).u(3, 1)
    w.u(1, int(sh.first))
    if BLA_W_LP <= sh.nal_type <= 23:
        w.u(1, 0)
    w.ue(sh.pps_id)
    if not sh.first:
        if pps["dependent_slices"]:
            w.u(1, 0)
        w.u(_bits_for(sps["ctbs_w"] * sps["ctbs_h"]), sh.address)
    w.u(pps["extra_bits"], 0)
    w.ue(sh.slice_type)
    if pps["output_flag"]:
        w.u(1, 1)
    if not sh.idr:
        w.u(sps["log2_max_poc_lsb"], sh.poc_lsb)
        w.u(1, 0).ue(0).ue(0)                      # an empty short-term set in the header
        if sps["long_term"]:
            if sps["num_long_term_sps"]:
                w.ue(0)
            w.ue(0)
        if sps["temporal_mvp"]:
            w.u(1, 0)
    if sps["sao"]:
        w.u(1, int(sh.sao_luma)).u(1, int(sh.sao_chroma))
    w.se(sh.qp_delta)
    if pps["slice_chroma_offsets"]:
        w.se(sh.cb_offset).se(sh.cr_offset)
    if pps["deblocking_override"]:
        w.u(1, int(sh.deblocking_override))
    if sh.deblocking_override:
        w.u(1, int(sh.deblocking_off))
        if not sh.deblocking_off:
            w.se(sh.beta_div2).se(sh.tc_div2)
    if pps["across_slices"] and (sh.sao_luma or sh.sao_chroma or not sh.deblocking_off):
        w.u(1, int(sh.across))
    return w.align(True)


# ---------------------------------------------------------------------------
# Writing parameter sets.
# ---------------------------------------------------------------------------

def nal_unit(kind: int, rbsp: bytes) -> bytes:
    """A NAL unit of ``kind`` (layer 0, TemporalId 0) around ``rbsp`` (its
    payload after the two-byte header), emulation prevention applied."""
    return bytes([kind << 1, 1]) + escape(np.frombuffer(rbsp, np.uint8)).tobytes()


MAIN_PROFILE, LEVEL = 1, 123                       # level 4.1


def _write_ptl(w: BitWriter) -> None:
    w.u(2, 0).u(1, 0).u(5, MAIN_PROFILE).u(32, 0x60000000)   # Main, compatible with Main 10
    w.u(4, 0b1001).u(44, 0).u(8, LEVEL)            # progressive, frame only


def encode_vps() -> bytes:
    w = BitWriter().u(4, 0).u(2, 3).u(6, 0).u(3, 0).u(1, 1).u(16, 0xFFFF)
    _write_ptl(w)
    w.u(1, 1).ue(0).ue(0).ue(0)                    # sub-layer ordering info
    w.u(6, 0).ue(0).u(1, 0).u(1, 0)                # layer sets, timing, extension
    return nal_unit(VPS_NUT, w.align(True))


def encode_sps(width: int, height: int, *, ctb_log2: int = 4, min_cb_log2: int = 3,
               bit_depth: int = 8, chroma_format: int = 1, scaling_list: bool = False,
               min_tb_log2: int = 2, max_tb_log2: int = 4, max_depth_intra: int = 1,
               pcm: Optional[Tuple[int, int, int, int, bool]] = None, sao: bool = True,
               log2_max_poc_lsb: int = 8,
               window: Tuple[int, int, int, int] = (0, 0, 0, 0), full_range: bool = False,
               matrix: Optional[int] = None) -> bytes:
    """An SPS (Main, 4:2:0, 8-bit) of ``width`` x ``height`` coded samples
    (multiples of the smallest coding block), cropped by ``window`` (left,
    right, top, bottom in chroma samples); ``pcm`` = (luma bits, chroma
    bits, smallest log2 size, largest log2 size, pcm_loop_filter_disabled).
    A VUI is written when the range or the matrix is given. ``bit_depth``,
    ``chroma_format`` (idc, not 3) and ``scaling_list`` (default lists)
    write sequences the decoder refuses."""
    w = BitWriter().u(4, 0).u(3, 0).u(1, 1)
    _write_ptl(w)
    w.ue(0).ue(chroma_format).ue(width).ue(height)
    w.u(1, int(any(window)))
    if any(window):
        for v in window:
            w.ue(v)
    w.ue(bit_depth - 8).ue(bit_depth - 8).ue(log2_max_poc_lsb - 4)
    w.u(1, 1).ue(0).ue(0).ue(0)                   # max_dec_pic_buffering_minus1, reorder
    w.ue(min_cb_log2 - 3).ue(ctb_log2 - min_cb_log2).ue(min_tb_log2 - 2)
    w.ue(max_tb_log2 - min_tb_log2).ue(0).ue(max_depth_intra)
    w.u(1, int(scaling_list))
    if scaling_list:
        w.u(1, 0)                                  # sps_scaling_list_data_present_flag
    w.u(1, 0).u(1, int(sao)).u(1, int(pcm is not None))
    if pcm is not None:
        bits_y, bits_c, lo, hi, no_filter = pcm
        w.u(4, bits_y - 1).u(4, bits_c - 1).ue(lo - 3).ue(hi - lo).u(1, int(no_filter))
    w.ue(0).u(1, 0).u(1, 0).u(1, 1)               # strong_intra_smoothing_enabled_flag
    vui = full_range or matrix is not None
    w.u(1, int(vui))
    if vui:
        w.u(1, 0).u(1, 0).u(1, 1).u(3, 5).u(1, int(full_range))
        w.u(1, int(matrix is not None))
        if matrix is not None:
            w.u(8, 2).u(8, 2).u(8, matrix)
        w.u(1, 0).u(3, 0).u(1, 0).u(1, 0).u(1, 0)
    w.u(1, 0)                                      # sps_extension_present_flag
    return nal_unit(SPS_NUT, w.align(True))


def encode_pps(*, init_qp: int = 26, sign_hiding: bool = False, transform_skip: bool = False,
               wpp: bool = False,
               cu_qp_delta_depth: Optional[int] = None, cb_qp_offset: int = 0,
               cr_qp_offset: int = 0, slice_chroma_offsets: bool = False,
               transquant_bypass: bool = False, across_slices: bool = True,
               deblocking: Optional[Tuple[bool, bool, int, int]] = None,
               dependent_slices: bool = False) -> bytes:
    """A PPS; ``cu_qp_delta_depth`` None turns cu_qp_delta off;
    ``deblocking`` = (override enabled, disabled, beta_offset_div2,
    tc_offset_div2) writes the deblocking control fields; ``wpp`` writes a
    PPS the decoder refuses."""
    w = BitWriter().ue(0).ue(0).u(1, int(dependent_slices)).u(1, 0)
    w.u(3, 0).u(1, int(sign_hiding)).u(1, 0).ue(0).ue(0).se(init_qp - 26)
    w.u(1, 0).u(1, int(transform_skip)).u(1, int(cu_qp_delta_depth is not None))
    if cu_qp_delta_depth is not None:
        w.ue(cu_qp_delta_depth)
    w.se(cb_qp_offset).se(cr_qp_offset).u(1, int(slice_chroma_offsets))
    w.u(1, 0).u(1, 0).u(1, int(transquant_bypass)).u(1, 0).u(1, int(wpp))
    w.u(1, int(across_slices)).u(1, int(deblocking is not None))
    if deblocking is not None:
        override, disabled, beta, tc = deblocking
        w.u(1, int(override)).u(1, int(disabled))
        if not disabled:
            w.se(beta).se(tc)
    w.u(1, 0).u(1, 0).ue(0).u(1, 0).u(1, 0)
    return nal_unit(PPS_NUT, w.align(True))


def with_slice_type(nal: bytes, sps_table: dict, pps_table: dict, slice_type: int) -> bytes:
    """An I slice's NAL unit with its header rewritten to ``slice_type``
    (a refusal fixture: the header is correct only up to slice_type)."""
    rbsp = _rbsp(nal)
    sh = parse_slice_header(rbsp, sps_table, pps_table)
    sh.slice_type = slice_type
    pps = pps_table[sh.pps_id]
    out = write_slice_header(sh, sps_table[pps["sps_id"]], pps) + rbsp[sh.data_offset:]
    return out[:2] + escape(np.frombuffer(out[2:], np.uint8)).tobytes()


# ---------------------------------------------------------------------------
# The native coding tree layer.
# ---------------------------------------------------------------------------

_STATUS = {-1: "bad arguments", -2: "a slice that runs past its end",
           -3: "coding tree units past the picture's end, or decoded twice",
           -4: "a cu_qp_delta out of range", -5: "a coefficient out of range or a last "
           "position outside its block", -6: "an encoder output buffer too small",
           -7: "a picture whose slices leave coding tree units undecoded"}
PARAM_INTS, SLICE_INTS, SAO_INTS = 22, 11, 24
KNOBS = ("best", "split_cu", "bypass", "pcm", "nxn", "split_tu", "transform_skip", "qp_delta",
         "dead_zone", "chroma_dm", "max_level")
# The contexts of I slices (hevc_tables.h's Context), by syntax element:
# (name, first ctxIdx, count).
CONTEXTS = (("sao_merge", 0, 1), ("sao_type_idx", 1, 1), ("split_cu_flag", 2, 3),
            ("cu_transquant_bypass_flag", 5, 1), ("cu_qp_delta_abs", 6, 2),
            ("part_mode", 8, 1), ("prev_intra_luma_pred_flag", 9, 1),
            ("intra_chroma_pred_mode", 10, 1), ("split_transform_flag", 11, 3),
            ("cbf_luma", 14, 2), ("cbf_chroma", 16, 4), ("transform_skip_flag", 20, 2),
            ("last_sig_coeff_x_prefix", 22, 18), ("last_sig_coeff_y_prefix", 40, 18),
            ("coded_sub_block_flag", 58, 4), ("sig_coeff_flag", 62, 42),
            ("coeff_abs_level_greater1_flag", 104, 24),
            ("coeff_abs_level_greater2_flag", 128, 6))
NUM_CONTEXTS = 134
# What the native encoder counts (its Stat order).
STAT_NAMES = tuple([f"luma_mode_{s}x{s}_{m}" for s in (4, 8, 16, 32) for m in range(35)]
                   + [f"chroma_mode_{m}" for m in range(5)]
                   + ["chroma_mode_34", "nxn", "pcm", "transquant_bypass", "transform_skip",
                      "sign_hidden", "cu_qp_delta_nonzero", "cu_qp_delta_suffix", "dst",
                      "dct_4", "dct_8", "dct_16", "dct_32", "scan_horizontal", "scan_vertical",
                      "strong_intra_smoothing", "reference_filter", "mpm", "rem_intra_mode",
                      "sao_band", "sao_edge_0", "sao_edge_90", "sao_edge_135", "sao_edge_45",
                      "sao_merge_left", "sao_merge_up", "level_escape", "rice_4",
                      "coded_sub_block_0", "chroma_4x4_at_blk3", "qp_pred_in_ctb"])
# What the decoder's loop filters count.
FILTER_NAMES = ("deblock_strong", "deblock_normal", "deblock_normal_p1", "deblock_no_change",
                "deblock_chroma", "deblock_skipped_edge", "deblock_pcm_or_bypass", "sao_band",
                "sao_edge", "sao_blocked_by_slice", "sao_picture_edge", "sao_pcm_or_bypass")


def _lib():
    from hive_tpu_torch import native

    lib = native.get_native_lib()
    if lib is None:
        raise RuntimeError(f"HEVC video decodes in hive_tpu_torch's native library "
                           f"(native/src/hevc_decode.cpp, built with g++), which is not "
                           f"available: {native.build_error()}")
    if (lib.hive_hevc_param_ints(), lib.hive_hevc_slice_ints()) != (PARAM_INTS, SLICE_INTS):
        raise RuntimeError("the native HEVC decoder's parameters do not match _params")
    return lib


def _pointers(*arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(*(a.ctypes.data for a in arrays))


def contexts_reachable() -> np.ndarray:
    """The contexts (NUM_CONTEXTS bools) that I slices of Main profile
    pictures can read: all but the luma last-position prefix's third (its
    4x4 blocks take contexts 0 and 1, 8x8 ones 3-5)."""
    reach = np.ones(NUM_CONTEXTS, bool)
    for first in (22, 40):
        reach[first + 2] = False
    return reach


def stat_counts() -> Tuple[int, int]:
    named, filters = ctypes.c_int32(0), ctypes.c_int32(0)
    total = _lib().hive_hevc_stat_counts(ctypes.byref(named), ctypes.byref(filters))
    if (named.value, filters.value) != (len(STAT_NAMES), len(FILTER_NAMES)):
        raise RuntimeError("the native HEVC encoder's counts do not match STAT_NAMES")
    return total, filters.value


def _params(sps: dict, pps: dict) -> np.ndarray:
    pcm = sps["pcm"]
    return np.array([sps["coded_width"], sps["coded_height"], sps["ctb_log2"], sps["min_cb_log2"],
                     sps["min_tb_log2"], sps["max_tb_log2"], sps["max_depth_intra"], pcm,
                     *(sps["pcm_bits"] if pcm else (8, 8)),
                     sps["pcm_min_log2"] if pcm else 0, sps["pcm_max_log2"] if pcm else 0,
                     sps["pcm_no_filter"] if pcm else 0, sps["sao"], sps["strong_smoothing"],
                     pps["sign_hiding"], pps["transform_skip"], pps["cu_qp_delta"],
                     pps["cu_qp_delta_depth"], pps["cb_qp_offset"], pps["cr_qp_offset"],
                     pps["transquant_bypass"]], np.int32)


def _slice_params(sh: SliceHeader, pps: dict, ctbs: int = 0) -> List[int]:
    return [sh.address, pps["init_qp"] + sh.qp_delta, sh.sao_luma, sh.sao_chroma, sh.cb_offset,
            sh.cr_offset, sh.deblocking_off, sh.beta_div2, sh.tc_div2, sh.across, ctbs]


# ---------------------------------------------------------------------------
# The decoder.
# ---------------------------------------------------------------------------

@dataclass
class Picture:
    """A decoded picture: its planes cropped to the conformance window
    (views of the coded ones), and what the output order needs."""

    poc: int
    irap: bool
    flush: bool                 # an IRAP picture with NoRaslOutputFlag: the output flushes
    y: Optional[np.ndarray] = None
    u: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None
    sample: int = -1            # the MP4 sample it came from, if the caller says


class HevcDecoder:
    """Decodes access units (lists of NAL units, emulation prevention still
    in) in decode order with :meth:`decode`;
    :func:`.h264_bits.display_order` puts the pictures in display order.
    With ``pixels`` False it reads only the headers (:func:`scan_track`).
    ``filter_stats`` (len(FILTER_NAMES) int64), when given, counts the loop
    filters' decisions."""

    def __init__(self, pixels: bool = True, filter_stats: Optional[np.ndarray] = None):
        self.pixels = pixels
        self.vps: Dict[int, dict] = {}
        self.sps: Dict[int, dict] = {}
        self.pps: Dict[int, dict] = {}
        self.prev_tid0_poc = 0
        self.first = True
        self.size: Optional[Tuple[int, int]] = None
        self.filter_stats = filter_stats
        # The deblocking offsets of the picture's last slice header: FFmpeg
        # keeps them for a slice that turns deblocking off by override, whose
        # neighbours' edges may read them (PERF.md); at a picture's first
        # slice they are whatever its frame thread parsed last, for which
        # this decoder takes the PPS's.
        self.offsets: Optional[Tuple[int, int]] = None

    def _parameter_set(self, nal: bytes) -> None:
        kind = nal_type(nal)
        rbsp = _rbsp(nal)
        if kind == VPS_NUT:
            vps = parse_vps(rbsp)
            self.vps[vps["id"]] = vps
        elif kind == SPS_NUT:
            sps = parse_sps(rbsp)
            check_sps(sps)
            self.sps[sps["id"]] = sps
        elif kind == PPS_NUT:
            pps = parse_pps(rbsp)
            check_pps(pps)
            self.pps[pps["id"]] = pps

    def headers(self, nal_units: Iterable[bytes]) -> List[Tuple[bytes, SliceHeader]]:
        """The access unit's parameter sets taken in; its slices' RBSPs and
        headers."""
        slices = []
        self.offsets = None
        for nal in nal_units:
            kind = nal_type(nal)
            if kind in (VPS_NUT, SPS_NUT, PPS_NUT):
                self._parameter_set(nal)
            elif kind < 32:
                rbsp = _rbsp(nal)
                sh = parse_slice_header(rbsp, self.sps, self.pps)
                if sh.deblocking_override and sh.deblocking_off:
                    pps = self.pps[sh.pps_id]
                    sh.beta_div2, sh.tc_div2 = self.offsets or (pps["beta_div2"], pps["tc_div2"])
                self.offsets = (sh.beta_div2, sh.tc_div2)
                slices.append((rbsp, sh))
            elif kind == EOS_NUT:
                self.first = True
        return slices

    def decode(self, nal_units: Iterable[bytes]) -> Optional[Picture]:
        return self.picture(self.headers(nal_units))

    def picture(self, slices: List[Tuple[bytes, SliceHeader]]) -> Optional[Picture]:
        if not slices:
            return None
        first = slices[0][1]
        if not first.first:
            raise ValueError("an HEVC access unit whose first slice segment does not start its "
                             "picture")
        if any(sh.first for _, sh in slices[1:]):
            raise ValueError("an HEVC access unit holds more than one picture")
        pps = self.pps[first.pps_id]
        sps = self.sps[pps["sps_id"]]
        if self.size is not None and self.size != (sps["coded_width"], sps["coded_height"]):
            raise _refuse("a change of picture size within the stream", INTER_ITEM)
        self.size = (sps["coded_width"], sps["coded_height"])
        no_rasl = first.idr or (first.irap and self.first)
        self.first = False
        poc = self._poc(first, sps, no_rasl)
        picture = Picture(poc=poc, irap=first.irap, flush=no_rasl)
        if not self.pixels:
            return picture
        lib = _lib()
        width, height = sps["coded_width"], sps["coded_height"]
        planes = (np.empty((height, width), np.uint8),
                  *(np.empty((height // 2, width // 2), np.uint8) for _ in range(2)))
        slices = sorted(slices, key=lambda s: s[1].address)
        params = _params(sps, pps)
        slice_params = np.array([_slice_params(sh, pps) for _, sh in slices], np.int32)
        buffers = [np.frombuffer(rbsp[sh.data_offset:] + bytes(16), np.uint8)
                   for rbsp, sh in slices]
        sizes = np.array([len(b) - 16 for b in buffers], np.int64)
        stats = self.filter_stats
        status = lib.hive_hevc_decode_picture(
            params.ctypes.data, len(slices), slice_params.ctypes.data, _pointers(*buffers),
            sizes.ctypes.data, _pointers(*planes),
            stats.ctypes.data if stats is not None else None)
        if status:
            raise ValueError(f"corrupt HEVC picture: {_STATUS.get(status, status)}")
        left, right, top, bottom = sps["crop"]
        picture.y = planes[0][top:height - bottom, left:width - right]
        picture.u, picture.v = (p[top // 2:(height - bottom) // 2, left // 2:(width - right) // 2]
                                for p in planes[1:])
        return picture

    def _poc(self, sh: SliceHeader, sps: dict, no_rasl: bool) -> int:
        """PicOrderCntVal (8.3.1)."""
        if sh.idr:
            poc = 0
        else:
            max_lsb = 1 << sps["log2_max_poc_lsb"]
            prev_lsb = self.prev_tid0_poc & (max_lsb - 1)
            prev_msb = self.prev_tid0_poc - prev_lsb
            if no_rasl:
                msb = 0
            elif sh.poc_lsb < prev_lsb and prev_lsb - sh.poc_lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif sh.poc_lsb > prev_lsb and sh.poc_lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            poc = msb + sh.poc_lsb
        # prevTid0Pic: TemporalId 0, not RASL / RADL, not a sub-layer
        # non-reference picture.
        if sh.temporal_id == 0 and not (sh.nal_type <= 14 and sh.nal_type % 2 == 0):
            self.prev_tid0_poc = poc
        return poc


def scan_track(parameter_sets: List[bytes], num_samples: int,
               read: Callable[[int], List[bytes]]) -> Tuple[dict, int, List[int]]:
    """The stream's first SPS, its reorder depth for
    :func:`.h264_bits.display_order` and the samples that hold IRAP
    pictures, after reading every sample's headers in decode order
    (``read(i)``: the NAL units of sample ``i``):
    refuses, before any picture is decoded, what the decoder does not
    decode, and POCs that the reorder depth cannot put in order."""
    decoder = HevcDecoder(pixels=False)
    for unit in parameter_sets:
        decoder._parameter_set(unit)
    pictures, irap = [], []
    for i in range(num_samples):
        picture = decoder.decode(read(i))
        if picture is not None:
            pictures.append(picture)
            if picture.irap:
                irap.append(i)
    if not decoder.sps:
        raise ValueError("the HEVC stream carries no sequence parameter set")
    sps = next(iter(decoder.sps.values()))
    if out_of_order(pictures, sps["reorder"]):
        raise _refuse(f"pictures whose POCs the stream's reorder depth "
                      f"(sps_max_num_reorder_pics {sps['reorder']}) does not put in order",
                      INTER_ITEM)
    return sps, sps["reorder"], irap


def parse_hvcc(config: bytes) -> Tuple[int, List[bytes]]:
    """(NAL length size, parameter set NAL units) of an hvcC record."""
    if len(config) < 23 or config[0] != 1:
        raise ValueError("corrupt hvcC record")
    length_size = (config[21] & 3) + 1
    pos, units = 23, []
    for _ in range(config[22]):
        count = int.from_bytes(config[pos + 1:pos + 3], "big")
        pos += 3
        for _ in range(count):
            n = int.from_bytes(config[pos:pos + 2], "big")
            units.append(bytes(config[pos + 2:pos + 2 + n]))
            pos += 2 + n
        if pos > len(config):
            raise ValueError("corrupt hvcC record: an array past its end")
    return length_size, units


def hvcc_record(vps: bytes, sps: bytes, pps: bytes) -> bytes:
    """An hvcC record (ISO/IEC 14496-15 8.3.3.1) of Main profile, 4-byte NAL
    lengths, with the three parameter sets."""
    ptl = bytes([MAIN_PROFILE]) + (0x60000000).to_bytes(4, "big") + bytes([0x90]) + bytes(5) \
        + bytes([LEVEL])
    head = bytes([1]) + ptl + bytes([0xF0, 0x00, 0xFC, 0xFD, 0xF8, 0xF8, 0, 0, 0x0F])
    arrays = b"".join(bytes([0x80 | kind]) + (1).to_bytes(2, "big") + len(unit).to_bytes(2, "big")
                      + unit for kind, unit in ((VPS_NUT, vps), (SPS_NUT, sps), (PPS_NUT, pps)))
    return head + bytes([3]) + arrays


# ---------------------------------------------------------------------------
# The writer.
# ---------------------------------------------------------------------------

@dataclass
class SlicePlan:
    first_ctb: int
    count: int
    qp_delta: int = 0
    sao_luma: bool = True
    sao_chroma: bool = True
    cb_offset: int = 0
    cr_offset: int = 0
    deblocking_override: bool = False
    deblocking_off: bool = False
    beta_div2: int = 0
    tc_div2: int = 0
    across: bool = True


@dataclass
class PicturePlan:
    """One picture: its NAL unit type, slices, the knobs of the native
    planner (KNOBS) and its seed, and each CTB's SAO parameters ((CTBs,
    SAO_INTS) int8: type of Y, Cb, Cr (0 off, 1 band, 2 edge; -1 / -2 in
    Y's place a merge left / up), edge class, band position, then four
    offsets of each component)."""

    nal_type: int
    slices: List[SlicePlan]
    knobs: Dict[str, int]
    seed: int
    sao: Optional[np.ndarray] = None


def knob_array(knobs: Dict[str, int]) -> np.ndarray:
    return np.array([knobs.get(name, 0) for name in KNOBS], np.int32)


def random_sao(rng: np.random.Generator, ctbs_w: int, ctbs_h: int,
               slices: List[SlicePlan]) -> np.ndarray:
    """Seeded SAO parameters of each CTB: merges where the syntax allows them,
    off, band offsets or an edge class, with offsets of -7..7."""
    sao = np.zeros((ctbs_w * ctbs_h, SAO_INTS), np.int8)
    start_of = np.zeros(ctbs_w * ctbs_h, np.int64)
    for s in slices:
        start_of[s.first_ctb:s.first_ctb + s.count] = s.first_ctb
    for addr in range(ctbs_w * ctbs_h):
        rx, ry = addr % ctbs_w, addr // ctbs_w
        left = rx > 0 and addr - 1 >= start_of[addr]
        up = ry > 0 and addr - ctbs_w >= start_of[addr]
        if (left or up) and rng.random() < 0.3:
            sao[addr, 0] = -1 if left and (not up or rng.random() < 0.5) else -2
            continue
        for c in (0, 1):
            kind = 0 if rng.random() < 0.2 else (1 if rng.random() < 0.4 else 2)
            components = (0,) if c == 0 else (1, 2)
            eo = int(rng.integers(0, 4))
            for k in components:
                sao[addr, k] = kind
                sao[addr, 3 + k] = eo
                sao[addr, 6 + k] = int(rng.integers(0, 32))
                offsets = rng.integers(0, 8, 4)
                if kind == 1:
                    offsets = offsets * rng.choice([-1, 1], 4)
                elif kind == 2:
                    offsets[2:] = -offsets[2:]
                sao[addr, 9 + 4 * k:13 + 4 * k] = offsets
    return sao


class Exerciser:
    """Seeded plans that code every path of the decoder: each picture's NAL
    unit type (an IDR picture every ``idr_every``, CRA pictures at share
    ``cra``, a fifth of the others TRAIL_N), one to ``max_slices`` slices at
    seeded CTB boundaries, each with its QP (within 8 of ``qp``), SAO flags,
    chroma QP offsets
    and deblocking override (``slice_options``: which slice fields vary),
    seeded SAO parameters, and the native planner's knobs: the shares (per
    mille) of split coding units, transquant bypass, PCM, NxN, split
    transform units and transform skip, the cu_qp_delta range, the dead
    zone and the largest level. ``knobs`` override the defaults."""

    def __init__(self, width: int, height: int, seed: int, *, ctb_log2: int = 4,
                 idr_every: int = 100, cra: float = 0.2, max_slices: int = 3, qp: int = 30,
                 slice_options: Sequence[str] = ("qp", "sao", "deblocking", "across"),
                 knobs: Optional[Dict[str, int]] = None):
        self.width, self.height, self.seed, self.ctb_log2 = width, height, seed, ctb_log2
        self.idr_every, self.cra, self.max_slices, self.qp = idr_every, cra, max_slices, qp
        self.slice_options = set(slice_options)
        self.knobs = dict(split_cu=500, bypass=60, pcm=60, nxn=400, split_tu=500,
                          transform_skip=300, qp_delta=6, dead_zone=400, chroma_dm=300,
                          max_level=4000)
        self.knobs.update(knobs or {})

    def __call__(self, index: int, sps: dict, pps: dict) -> PicturePlan:
        rng = np.random.default_rng([self.seed, index])
        if index % self.idr_every == 0:
            kind = IDR_W_RADL if index // self.idr_every % 2 == 0 else IDR_N_LP
        elif rng.random() < self.cra:
            kind = CRA_NUT
        else:
            kind = TRAIL_N if rng.random() < 0.2 else TRAIL_R
        total = sps["ctbs_w"] * sps["ctbs_h"]
        count = int(rng.integers(1, self.max_slices + 1))
        cuts = sorted(set(rng.integers(1, total, count - 1).tolist())) if total > 1 else []
        bounds = [0] + cuts + [total]
        slices = []
        for first, end in zip(bounds[:-1], bounds[1:]):
            s = SlicePlan(first, end - first)
            if "qp" in self.slice_options:
                s.qp_delta = self.qp - pps["init_qp"] + int(rng.integers(-8, 9))
            else:
                s.qp_delta = self.qp - pps["init_qp"]
            if "sao" in self.slice_options:
                s.sao_luma, s.sao_chroma = bool(rng.random() < 0.8), bool(rng.random() < 0.8)
            if "chroma" in self.slice_options and pps["slice_chroma_offsets"]:
                # The slice's offsets, so that each sum with the PPS's lies
                # in -12..12.
                s.cb_offset, s.cr_offset = (
                    int(np.clip(rng.integers(-12, 13) - pps[key], -12, 12))
                    for key in ("cb_qp_offset", "cr_qp_offset"))
            if "deblocking" in self.slice_options and pps["deblocking_override"]:
                s.deblocking_override = bool(rng.random() < 0.7)
                if s.deblocking_override:
                    # Not the first slice: FFmpeg's offsets of such a slice
                    # are the previous slice's (PERF.md).
                    s.deblocking_off = bool(rng.random() < 0.25) and first > 0
                    if not s.deblocking_off:
                        s.beta_div2, s.tc_div2 = (int(v) for v in rng.integers(-6, 7, 2))
            if "across" in self.slice_options:
                s.across = bool(rng.random() < 0.5)
            slices.append(s)
        sao = random_sao(rng, sps["ctbs_w"], sps["ctbs_h"], slices)
        return PicturePlan(kind, slices, dict(self.knobs), int(rng.integers(0, 2 ** 62)), sao)


class IntraPlanner:
    """Plans for a real picture: an IDR picture first, CRA pictures every
    ``cra_every`` after it (so that a seek decodes one picture) and TRAIL_R
    pictures otherwise, ``slices`` slices of equal CTB counts, QP ``qp``,
    each coding unit of 16x16 (split from larger CTBs) with the intra mode
    nearest the target, transform units of at most 16x16, and SAO: an edge
    class a CTB (cycling) with offsets 1, 0, 0, -1."""

    def __init__(self, width: int, height: int, *, qp: int = 27, slices: int = 1,
                 cra_every: int = 1000):
        self.width, self.height, self.qp, self.slices = width, height, qp, slices
        self.cra_every = cra_every

    def __call__(self, index: int, sps: dict, pps: dict) -> PicturePlan:
        total = sps["ctbs_w"] * sps["ctbs_h"]
        count = min(self.slices, total)
        bounds = [round(k * total / count) for k in range(count + 1)]
        slices = [SlicePlan(a, b - a, qp_delta=self.qp - pps["init_qp"], sao_luma=True,
                            sao_chroma=True) for a, b in zip(bounds[:-1], bounds[1:])]
        sao = np.zeros((total, SAO_INTS), np.int8)
        for addr in range(total):
            sao[addr, 0:3] = 2
            sao[addr, 3:6] = addr % 4
            sao[addr, 9:21] = [1, 0, 0, -1] * 3
        split = 1000 if sps["ctb_log2"] > 4 else 0
        knobs = dict(best=1, split_cu=split, dead_zone=450, max_level=32767)
        kind = IDR_W_RADL if index == 0 else (
            CRA_NUT if index % self.cra_every == 0 else TRAIL_R)
        return PicturePlan(kind, slices, knobs, index, sao)


def _coded_planes(planes, width: int, height: int):
    def pad(p, rows, cols):
        h, w = p.shape
        return np.ascontiguousarray(np.pad(p, ((0, rows - h), (0, cols - w)), mode="edge"))

    y, u, v = planes
    return pad(y, height, width), pad(u, height // 2, width // 2), pad(v, height // 2, width // 2)


def write_hevc_mp4(path: str, frames: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                   planner: Callable[[int, dict, dict], PicturePlan], *,
                   ctb_log2: int = 4, max_tb_log2: int = 4, max_depth_intra: int = 1,
                   pcm: Optional[Tuple[int, int, int, int, bool]] = None, sao: bool = True,
                   log2_max_poc_lsb: int = 8,
                   extra_window: Tuple[int, int, int, int] = (0, 0, 0, 0), init_qp: int = 26,
                   sign_hiding: bool = False, transform_skip: bool = False,
                   cu_qp_delta_depth: Optional[int] = None, cb_qp_offset: int = 0,
                   cr_qp_offset: int = 0, slice_chroma_offsets: bool = False,
                   transquant_bypass: bool = False, across_slices: bool = True,
                   deblocking: Optional[Tuple[bool, bool, int, int]] = None,
                   fourcc: bytes = b"hvc1", in_band: bool = False) -> dict:
    """Write ``frames`` (uint8 Y, U, V planes in display order, an even
    size; may be lazy) as an all-intra HEVC MP4 at 30 fps, each picture as
    ``planner(display index, sps, pps)`` plans it (:class:`Exerciser`,
    :class:`IntraPlanner`), in display order. The coded size is the
    frame's rounded up to the smallest coding block (8x8),
    cropped back by the conformance window (plus ``extra_window``, in chroma
    samples). The SPS and PPS options are :func:`encode_sps` and
    :func:`encode_pps`'s. ``fourcc`` b"hev1" with ``in_band`` repeats the
    parameter sets in each IRAP sample. Returns the counts of
    :data:`STAT_NAMES` over the file, the contexts' decisions
    (``contexts``) and counts of the picture-level paths."""
    height, width = frames[0][0].shape
    n = len(frames)
    coded_w, coded_h = -(-width // 8) * 8, -(-height // 8) * 8
    left, right, top, bottom = extra_window
    window = (left, right + (coded_w - width) // 2, top, bottom + (coded_h - height) // 2)
    vps_unit = encode_vps()
    sps_unit = encode_sps(coded_w, coded_h, ctb_log2=ctb_log2, max_tb_log2=max_tb_log2,
                          max_depth_intra=max_depth_intra, pcm=pcm, sao=sao,
                          log2_max_poc_lsb=log2_max_poc_lsb, window=window)
    pps_unit = encode_pps(init_qp=init_qp, sign_hiding=sign_hiding, transform_skip=transform_skip,
                          cu_qp_delta_depth=cu_qp_delta_depth, cb_qp_offset=cb_qp_offset,
                          cr_qp_offset=cr_qp_offset, slice_chroma_offsets=slice_chroma_offsets,
                          transquant_bypass=transquant_bypass, across_slices=across_slices,
                          deblocking=deblocking)
    decoder = HevcDecoder()
    decoder.decode([vps_unit, sps_unit, pps_unit])
    sps, pps = decoder.sps[0], decoder.pps[0]
    lib = _lib()
    total_stats, _ = stat_counts()
    totals = np.zeros(total_stats, np.int64)
    params = _params(sps, pps)
    counts = dict.fromkeys(("pictures", "idr_w_radl", "idr_n_lp", "cra", "trail_r", "trail_n",
                            "slices", "multi_slice_pictures", "slice_qp_varies",
                            "slice_sao_off", "slice_chroma_offsets", "deblocking_override",
                            "deblocking_off_slices", "deblocking_offsets", "across_off",
                            "poc_msb_wrap", "sao_ctbs"), 0)
    names = {IDR_W_RADL: "idr_w_radl", IDR_N_LP: "idr_n_lp", CRA_NUT: "cra",
             TRAIL_R: "trail_r", TRAIL_N: "trail_n"}
    sync: List[bool] = []
    max_lsb = 1 << log2_max_poc_lsb

    def samples() -> Iterator[bytes]:
        idr_display = 0
        for k in range(n):
            plan = planner(k, sps, pps)
            if k == 0 and plan.nal_type not in (IDR_W_RADL, IDR_N_LP):
                raise ValueError("an HEVC stream starts with an IDR picture")
            if plan.nal_type in (IDR_W_RADL, IDR_N_LP):
                idr_display = k
            source = _coded_planes(frames[k], coded_w, coded_h)
            recon = tuple(np.zeros_like(p) for p in source)
            headers, slice_params = [], []
            for number, s in enumerate(plan.slices):
                sh = SliceHeader(plan.nal_type, first=number == 0, address=s.first_ctb,
                                 poc_lsb=(k - idr_display) % max_lsb,
                                 sao_luma=s.sao_luma and sps["sao"],
                                 sao_chroma=s.sao_chroma and sps["sao"], qp_delta=s.qp_delta,
                                 cb_offset=s.cb_offset, cr_offset=s.cr_offset,
                                 deblocking_override=s.deblocking_override,
                                 deblocking_off=s.deblocking_off if s.deblocking_override
                                 else bool(pps["deblocking_off"]),
                                 beta_div2=s.beta_div2 if s.deblocking_override
                                 else pps["beta_div2"],
                                 tc_div2=s.tc_div2 if s.deblocking_override else pps["tc_div2"],
                                 across=s.across if pps["across_slices"] else False)
                if not (sh.sao_luma or sh.sao_chroma or not sh.deblocking_off):
                    sh.across = bool(pps["across_slices"])
                headers.append(np.frombuffer(write_slice_header(sh, sps, pps), np.uint8))
                slice_params.append(_slice_params(sh, pps, s.count))
                counts["slice_sao_off"] += not (sh.sao_luma and sh.sao_chroma)
                counts["slice_chroma_offsets"] += bool(s.cb_offset or s.cr_offset)
                counts["deblocking_override"] += s.deblocking_override
                counts["deblocking_off_slices"] += sh.deblocking_off
                counts["deblocking_offsets"] += bool(sh.beta_div2 or sh.tc_div2)
                counts["across_off"] += not sh.across
            counts["slice_qp_varies"] += len({s.qp_delta for s in plan.slices}) > 1
            slice_params = np.array(slice_params, np.int32)
            sao_table = plan.sao if plan.sao is not None else \
                np.zeros((sps["ctbs_w"] * sps["ctbs_h"], SAO_INTS), np.int8)
            sao_table = np.ascontiguousarray(sao_table, np.int8)
            counts["sao_ctbs"] += int((sao_table[:, 0] != 0).sum())
            capacity = 4096 + 2 * coded_w * coded_h * 3
            out = np.empty(capacity, np.uint8)
            sizes = np.zeros(len(plan.slices), np.int64)
            knobs = knob_array(plan.knobs)
            size = lib.hive_hevc_encode_picture(
                params.ctypes.data, len(plan.slices), slice_params.ctypes.data, knobs.ctypes.data,
                ctypes.c_uint64(plan.seed), _pointers(*source), _pointers(*recon),
                _pointers(*headers), np.array([len(h) for h in headers], np.int64).ctypes.data,
                sao_table.ctypes.data, out.ctypes.data, capacity, sizes.ctypes.data,
                totals.ctypes.data)
            if size < 0:
                raise ValueError(f"HEVC picture encode failed: {_STATUS.get(int(size), size)}")
            units, at = [], 0
            for length in sizes.tolist():
                rbsp = out[at:at + length]
                units.append(bytes(rbsp[:2]) + escape(rbsp[2:]).tobytes())
                at += length
            irap = plan.nal_type in (IDR_W_RADL, IDR_N_LP, CRA_NUT)
            if in_band and irap:
                units = [vps_unit, sps_unit, pps_unit] + units
            sync.append(irap)
            counts["pictures"] += 1
            counts[names[plan.nal_type]] += 1
            counts["slices"] += len(plan.slices)
            counts["multi_slice_pictures"] += len(plan.slices) > 1
            counts["poc_msb_wrap"] += k - idr_display >= max_lsb
            yield b"".join(len(u).to_bytes(4, "big") + u for u in units)

    entry = mp4.visual_entry(fourcc, width, height,
                             mp4.box(b"hvcC", hvcc_record(vps_unit, sps_unit, pps_unit)))
    mp4.write_mp4(path, entry, samples(), width=width, height=height, timescale=30,
                  durations=[1] * n, sync=sync)
    result = dict(zip(STAT_NAMES, totals[:len(STAT_NAMES)].tolist()))
    result.update(counts)
    result["contexts"] = totals[len(STAT_NAMES):]
    return result
