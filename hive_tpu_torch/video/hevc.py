"""HEVC video (ITU-T H.265), Main profile I, P and B pictures, both ways,
as FFmpeg's ``hevc`` decoder, and so ``cv2.VideoCapture``, reads them.

**The reader** (:class:`HevcDecoder`) parses the two-byte NAL unit header,
every video, sequence and picture parameter set field (``profile_tier_level``,
the short-term reference picture sets with their used flags and inter-set
prediction, the long-term candidates, the conformance window in chroma units, the VUI's range and
matrix, its HRD parameters) and each slice segment header
(:func:`parse_vps`, :func:`parse_sps`, :func:`parse_pps`,
:func:`parse_slice_header`: the long-term entries, the lists' sizes and modification,
``pred_weight_table``, the collocated picture, MaxNumMergeCand); it derives
each picture's POC (8.3.1), applies its reference picture set to the
decoded picture buffer (8.3.2, short- and long-term), builds each slice's lists
(8.3.4), drops the RASL pictures of an IRAP picture with NoRaslOutputFlag (IDR, BLA,
the first CRA) and honours no_output_of_prior_pics_flag as FFmpeg does, and
decodes each picture's slices in one native call
(``native/src/hevc_decode.cpp``: the coding quadtree, intra and inter
prediction with merge, AMVP and temporal candidates, residual coding, the
transforms, then deblocking and SAO), given the reference pictures' planes
and the collocated picture's motion field. There is no numpy decoder beside
the native one: without a C++ toolchain it raises, naming the failed build.
HEVC decoding is exact by specification, so the planes equal FFmpeg's bit
for bit; what the port copies from FFmpeg is the output order
(:func:`output_order`: the lowest POC pending goes out while more pictures
are pending than the highest sub-layer's ``sps_max_num_reorder_pics`` or the
DPB holds more than its ``sps_max_dec_pic_buffering``, every picture pending
goes out (or, with no_output_of_prior_pics_flag, is dropped) at each IRAP
picture with NoRaslOutputFlag, pictures with ``pic_output_flag`` 0 are never
pending; :func:`scan_track` refuses a stream whose POCs that order does not
sort).

Refused by name before any picture is decoded (:func:`scan_track`), naming
the ROADMAP Queue 1 sub-item that will lift it
(:class:`~hive_tpu_torch.video.mp4.UnsupportedVideoError`): a change of
picture size within the stream and an output order that does not sort
the POCs (9c-2b);
scaling lists, tiles, WPP (``entropy_coding_sync_enabled_flag``),
dependent slice segments, constrained intra prediction, and a conformance
window cropping the left side by other than a multiple of 64 luma samples,
which cv2's FFmpeg rescales (9c-3); depths above 8 bits (Main 10), chroma
other than 4:2:0 and the range and other extensions (9c-4).

**The writer** (:func:`write_hevc_mp4`) makes such files from uint8 4:2:0
planes, for the tests and ``chip_smoke.py``: the parameter sets
(:func:`encode_vps`, :func:`encode_sps`, :func:`encode_pps`) from its
options, each picture's NAL unit type, TemporalId, reference picture set
(:func:`reference_sets`, from the pictures each predicts from) and slices
(their type, QP, SAO, chroma QP offsets, deblocking fields, lists, weights
and merge candidates) and each CTB's SAO parameters from a planner
(:class:`Exerciser`: seeded choices of every path of the decoder, in a
:class:`GopStructure` for P and B pictures; :class:`IntraPlanner`: a real
picture at a fixed QP; :class:`InterPlanner`: a real clip as x265's medium
preset codes it), and each coding unit's choices from the planner's knobs,
drawn in the native encoder (seeded) or, for a real picture, the intra mode
or motion nearest the target. The native encoder shares the decoder's
prediction and reconstruction, and counts each path it writes and each
CABAC context it codes under each initType.
"""

from __future__ import annotations

import ctypes
import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from hive_tpu_torch.video import mp4
from hive_tpu_torch.video.h264_bits import BitReader, BitWriter, escape, unescape
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
SUBSET = "Main profile pictures (I, P and B slices of 8-bit 4:2:0 pictures)"
# ROADMAP Queue 1's sub-items of HEVC.
STREAM_ITEM, TOOLS_ITEM, RANGE_ITEM = "9c-2b", "9c-3", "9c-4"


def _refuse(what: str, item: str) -> UnsupportedVideoError:
    """The refusal of a feature outside the subset, naming the ROADMAP
    Queue 1 sub-item that will lift it: 9c-2b (a change of picture size,
    an output order that leaves POCs unsorted), 9c-3 (coding tools) or 9c-4 (Main 10 and the range
    extensions)."""
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


# A short-term reference picture set: (delta POC, used_by_curr_pic) pairs,
# the negative deltas first from the nearest, then the positive ones from
# the nearest (DeltaPocS0 / UsedByCurrPicS0, then the S1 pair, 7.4.8).
Rps = Tuple[Tuple[int, bool], ...]


def _sorted_rps(entries: Iterable[Tuple[int, bool]]) -> Rps:
    entries = list(entries)
    return tuple(sorted((e for e in entries if e[0] < 0), key=lambda e: -e[0])
                 + sorted((e for e in entries if e[0] > 0), key=lambda e: e[0]))


def _st_ref_pic_set(r: BitReader, idx: int, sets: List[Rps], in_header: bool = False) -> Rps:
    """One st_ref_pic_set (7.3.7) after ``sets``, the SPS's (all of them in
    a slice header), predicted from one of them where
    inter_ref_pic_set_prediction_flag says (7-61, 7-62)."""
    if idx and r.u(1):                             # inter_ref_pic_set_prediction_flag
        delta_idx = r.ue() + 1 if in_header else 1
        if delta_idx > idx:
            raise ValueError("corrupt HEVC short-term RPS: delta_idx_minus1 out of range")
        ref = sets[idx - delta_idx]
        sign, magnitude = r.u(1), r.ue() + 1
        delta_rps = -magnitude if sign else magnitude
        entries = []
        for j in range(len(ref) + 1):
            used = r.u(1)
            if used or r.u(1):                     # use_delta_flag
                entries.append(((ref[j][0] if j < len(ref) else 0) + delta_rps, bool(used)))
        return _sorted_rps(e for e in entries if e[0])
    num_negative, num_positive = r.ue(), r.ue()
    if num_negative + num_positive > 16:
        raise ValueError("corrupt HEVC short-term RPS: more than 16 pictures")
    entries, poc = [], 0
    for _ in range(num_negative):
        poc -= r.ue() + 1
        entries.append((poc, bool(r.u(1))))
    poc = 0
    for _ in range(num_positive):
        poc += r.ue() + 1
        entries.append((poc, bool(r.u(1))))
    return tuple(entries)


def _write_st_ref_pic_set(w: BitWriter, idx: int, sets: Sequence[Rps], rps: Rps,
                          predict: bool = True) -> None:
    """The st_ref_pic_set of ``rps`` as set ``idx`` after ``sets`` (in a
    slice header, idx = len(sets)): predicted from the earlier set that
    can give it (the nearest first), else coded explicitly."""
    if idx:
        candidates = [idx - 1] if idx < len(sets) else range(idx - 1, -1, -1)
        for ref_idx in (candidates if predict else ()):
            ref = sets[ref_idx]
            want = dict(rps)
            for delta_rps in sorted({d - r for d, _ in rps for r, _ in ref} | {d for d, _ in rps},
                                    key=abs):
                if not delta_rps or abs(delta_rps) > 1 << 15:
                    continue
                reach = [(r + delta_rps) for r, _ in ref] + [delta_rps]
                if set(want) <= {d for d in reach if d}:
                    w.u(1, 1)
                    if idx == len(sets):
                        w.ue(idx - 1 - ref_idx)
                    w.u(1, int(delta_rps < 0)).ue(abs(delta_rps) - 1)
                    for d in reach:
                        used = d in want and want[d]
                        w.u(1, int(used))
                        if not used:
                            w.u(1, int(d in want))
                    return
        w.u(1, 0)
    negative = [e for e in rps if e[0] < 0]
    positive = [e for e in rps if e[0] > 0]
    w.ue(len(negative)).ue(len(positive))
    prev = 0
    for d, used in negative:
        w.ue(prev - d - 1).u(1, int(used))
        prev = d
    prev = 0
    for d, used in positive:
        w.ue(d - prev - 1).u(1, int(used))
        prev = d


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
    sps["lt_sps"] = []                             # (lt_ref_pic_poc_lsb_sps, used)
    if sps["long_term"]:
        for _ in range(r.ue()):
            sps["lt_sps"].append((r.u(sps["log2_max_poc_lsb"]), bool(r.u(1))))
    sps["num_long_term_sps"] = len(sps["lt_sps"])
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
    pps["num_ref_default"] = (r.ue() + 1, r.ue() + 1)
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
    pps["parallel_merge_log2"] = r.ue() + 2
    pps["header_extension"] = r.u(1)
    pps["extensions"] = r.u(1) and r.u(8)
    return pps


def check_pps(pps: dict) -> None:
    if pps["constrained_intra"]:
        raise _refuse("constrained intra prediction (constrained_intra_pred_flag)", TOOLS_ITEM)
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
    if max(pps["num_ref_default"]) > 15:
        raise ValueError("corrupt HEVC PPS: num_ref_idx_default_active_minus1 out of range")


# ---------------------------------------------------------------------------
# Slice segment headers.
# ---------------------------------------------------------------------------

@dataclass
class WeightTable:
    """pred_weight_table() (7.3.6.3) as coded: the luma and chroma
    log2 denominators and, for each list, each reference's luma (delta
    weight, offset) and chroma ((delta weight, delta offset) of Cb, of Cr),
    None where its flag is 0."""

    luma_denom: int = 0
    chroma_denom: int = 0
    luma: Tuple[List[Optional[Tuple[int, int]]], List[Optional[Tuple[int, int]]]] = \
        field(default_factory=lambda: ([], []))
    chroma: Tuple[list, list] = field(default_factory=lambda: ([], []))

    def values(self, l: int, i: int) -> List[int]:
        """(w, o) of luma, Cb and Cr of list ``l``'s reference ``i``
        (8.5.3.3.4.3's LumaWeightLX ... ChromaOffsetLX)."""
        out = []
        luma = self.luma[l][i] if i < len(self.luma[l]) else None
        out += [(1 << self.luma_denom) + luma[0], luma[1]] if luma else [1 << self.luma_denom, 0]
        chroma = self.chroma[l][i] if i < len(self.chroma[l]) else None
        for c in range(2):
            if chroma:
                w = (1 << self.chroma_denom) + chroma[c][0]
                o = min(127, max(-128, 128 + chroma[c][1] - ((128 * w) >> self.chroma_denom)))
                out += [w, o]
            else:
                out += [1 << self.chroma_denom, 0]
        return out


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
    rps: Rps = ()                   # the picture's short-term reference picture set
    rps_idx: int = -1               # the SPS's set it names; -1: coded in the header
    # The long-term entries: (PocLsbLt, used, delta_poc_msb_present_flag,
    # DeltaPocMsbCycleLt, the SPS candidate it names or -1), those naming
    # SPS candidates first.
    long_term: Tuple[Tuple[int, bool, bool, int, int], ...] = ()
    no_output_of_prior_pics: bool = False
    tmvp: bool = False              # slice_temporal_mvp_enabled_flag
    sao_luma: bool = False
    sao_chroma: bool = False
    num_ref: Tuple[int, int] = (0, 0)
    ref_override: bool = False      # num_ref_idx_active_override_flag
    list_entry: Tuple[Optional[Tuple[int, ...]], Optional[Tuple[int, ...]]] = (None, None)
    mvd_l1_zero: bool = False
    cabac_init: bool = False
    col_from_l0: bool = True
    col_ref_idx: int = 0
    weights: Optional[WeightTable] = None
    max_merge: int = 5
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

    @property
    def bla(self) -> bool:
        return self.nal_type in (BLA_W_LP, BLA_W_RADL, BLA_N_LP)

    @property
    def rasl(self) -> bool:
        return self.nal_type in (RASL_N, RASL_R)

    @property
    def sub_layer_non_reference(self) -> bool:
        return self.nal_type <= 14 and self.nal_type % 2 == 0

    @property
    def init_type(self) -> int:
        """The CABAC contexts' initType (9-7)."""
        if self.slice_type == I_SLICE:
            return 0
        return (2 if self.cabac_init else 1) if self.slice_type == P_SLICE else \
            (1 if self.cabac_init else 2)


def _bits_for(count: int) -> int:
    """Ceil(Log2(count))."""
    return max(0, (count - 1).bit_length())


def check_nal_type(kind: int) -> None:
    if 10 <= kind <= 15 or 22 <= kind <= 31:
        raise ValueError(f"corrupt HEVC stream: reserved VCL NAL unit type {kind}")


def _pred_weight_table(r: BitReader, sh: SliceHeader) -> WeightTable:
    table = WeightTable(luma_denom=r.ue())
    table.chroma_denom = table.luma_denom + r.se()
    if not (0 <= table.luma_denom <= 7 and 0 <= table.chroma_denom <= 7):
        raise ValueError("corrupt HEVC pred_weight_table: a log2 denominator out of range")
    for l in range(2 if sh.slice_type == B_SLICE else 1):
        n = sh.num_ref[l]
        luma_flags = [r.u(1) for _ in range(n)]
        chroma_flags = [r.u(1) for _ in range(n)]
        for i in range(n):
            luma = (r.se(), r.se()) if luma_flags[i] else None
            chroma = ((r.se(), r.se()), (r.se(), r.se())) if chroma_flags[i] else None
            if (luma and not (-128 <= luma[0] <= 127 and -128 <= luma[1] <= 127)) or \
                    (chroma and not all(-128 <= dw <= 127 and -512 <= do <= 511
                                        for dw, do in chroma)):
                raise ValueError("corrupt HEVC pred_weight_table: a weight or offset out of range")
            table.luma[l].append(luma)
            table.chroma[l].append(chroma)
    return table


def _write_pred_weight_table(w: BitWriter, sh: SliceHeader) -> None:
    table = sh.weights or WeightTable()
    w.ue(table.luma_denom).se(table.chroma_denom - table.luma_denom)
    for l in range(2 if sh.slice_type == B_SLICE else 1):
        n = sh.num_ref[l]
        luma = [table.luma[l][i] if i < len(table.luma[l]) else None for i in range(n)]
        chroma = [table.chroma[l][i] if i < len(table.chroma[l]) else None for i in range(n)]
        for v in luma + chroma:
            w.u(1, int(v is not None))
        for i in range(n):
            if luma[i]:
                w.se(luma[i][0]).se(luma[i][1])
            if chroma[i]:
                for dw, do in chroma[i]:
                    w.se(dw).se(do)


def ref_list(before: Sequence, after: Sequence, n: int, entries: Optional[Sequence[int]],
             l: int, long_term: Sequence = ()) -> list:
    """RefPicListX (8.3.4) of ``n`` entries from the pictures before and
    after the current one (RefPicSetStCurrBefore / After, nearest first) and
    the long-term ones (RefPicSetLtCurr), modified by ``entries``
    (list_entry_lX) where given."""
    order = (list(before) + list(after) if l == 0 else list(after) + list(before)) + \
        list(long_term)
    if not n:
        return []
    temp = [order[i % len(order)] for i in range(max(n, len(order)))]
    return [temp[entries[i]] if entries else temp[i] for i in range(n)]


def num_pic_total_curr(sh: SliceHeader) -> int:
    """NumPicTotalCurr (7-55): the pictures the current one may refer to."""
    return sum(used for _, used in sh.rps) + sum(e[1] for e in sh.long_term)


def _long_term_entries(r: BitReader, sps: dict) -> Tuple[Tuple[int, bool, bool, int, int], ...]:
    """A slice header's long-term entries (7.3.6.1) with
    DeltaPocMsbCycleLt summed (7-52)."""
    candidates = sps["lt_sps"]
    num_sps = r.ue() if candidates else 0
    num_pics = r.ue()
    if num_sps > len(candidates) or num_sps + num_pics > 32:
        raise ValueError("corrupt HEVC slice header: too many long-term entries")
    entries, cycle = [], 0
    for i in range(num_sps + num_pics):
        if i < num_sps:
            idx = r.u(_bits_for(len(candidates))) if len(candidates) > 1 else 0
            if idx >= len(candidates):
                raise ValueError("corrupt HEVC slice header: lt_idx_sps out of range")
            lsb, used = candidates[idx]
        else:
            idx = -1
            lsb, used = r.u(sps["log2_max_poc_lsb"]), bool(r.u(1))
        present = bool(r.u(1))
        delta = r.ue() if present else 0
        cycle = delta if i in (0, num_sps) else cycle + delta
        entries.append((lsb, used, present, cycle, idx))
    return tuple(entries)


def _write_long_term_entries(w: BitWriter, sps: dict, entries) -> None:
    num_sps = sum(e[4] >= 0 for e in entries)
    if sps["lt_sps"]:
        w.ue(num_sps)
    w.ue(len(entries) - num_sps)
    cycle = 0
    for i, (lsb, used, present, total, idx) in enumerate(entries):
        if i < num_sps:
            if len(sps["lt_sps"]) > 1:
                w.u(_bits_for(len(sps["lt_sps"])), idx)
        else:
            w.u(sps["log2_max_poc_lsb"], lsb).u(1, int(used))
        w.u(1, int(present))
        previous = 0 if i in (0, num_sps) else cycle
        if present:
            w.ue(total - previous)
        cycle = total if present else previous


def parse_slice_header(rbsp: bytes, sps_table: dict, pps_table: dict) -> SliceHeader:
    """A slice segment header (7.3.6), its NAL header first; refuses what
    the decoder does not decode."""
    kind = nal_type(rbsp)
    check_nal_type(kind)
    r = BitReader(rbsp, 16)
    sh = SliceHeader(kind, temporal_id=(rbsp[1] & 7) - 1)
    sh.first = bool(r.u(1))
    if BLA_W_LP <= kind <= 23:
        sh.no_output_of_prior_pics = bool(r.u(1))
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
    if sh.slice_type not in (B_SLICE, P_SLICE, I_SLICE) or (sh.irap and sh.slice_type != I_SLICE):
        raise ValueError(f"corrupt HEVC slice header: slice_type {sh.slice_type}")
    if pps["output_flag"]:
        sh.pic_output = bool(r.u(1))
    if not sh.idr:
        sh.poc_lsb = r.u(sps["log2_max_poc_lsb"])
        sets = sps["st_rps"]
        if not r.u(1):                             # short_term_ref_pic_set_sps_flag
            sh.rps = _st_ref_pic_set(r, len(sets), sets, True)
        else:
            sh.rps_idx = r.u(_bits_for(len(sets))) if len(sets) > 1 else 0
            if sh.rps_idx >= len(sets):
                raise ValueError("corrupt HEVC slice header: short_term_ref_pic_set_idx out of "
                                 "range")
            sh.rps = sets[sh.rps_idx]
        if sps["long_term"]:
            sh.long_term = _long_term_entries(r, sps)
        if sps["temporal_mvp"]:
            sh.tmvp = bool(r.u(1))
    if sps["sao"]:
        sh.sao_luma, sh.sao_chroma = bool(r.u(1)), bool(r.u(1))
    if sh.slice_type != I_SLICE:
        b = sh.slice_type == B_SLICE
        sh.num_ref = (pps["num_ref_default"][0], pps["num_ref_default"][1] if b else 0)
        sh.ref_override = bool(r.u(1))
        if sh.ref_override:
            sh.num_ref = (r.ue() + 1, r.ue() + 1 if b else 0)
        if max(sh.num_ref) > 15:
            raise ValueError("corrupt HEVC slice header: num_ref_idx_active_minus1 out of range")
        total = num_pic_total_curr(sh)
        if not total:
            raise ValueError("corrupt HEVC slice header: a P or B slice with no reference "
                             "picture")
        if pps["lists_modification"] and total > 1:
            entries = []
            for l in range(2 if b else 1):
                entries.append(tuple(r.u(_bits_for(total)) for _ in range(sh.num_ref[l]))
                               if r.u(1) else None)
            sh.list_entry = (entries[0], entries[1] if b else None)
            if any(e >= total for lst in sh.list_entry if lst for e in lst):
                raise ValueError("corrupt HEVC slice header: list_entry out of range")
        if b:
            sh.mvd_l1_zero = bool(r.u(1))
        if pps["cabac_init_present"]:
            sh.cabac_init = bool(r.u(1))
        if sh.tmvp:
            if b:
                sh.col_from_l0 = bool(r.u(1))
            if sh.num_ref[0 if sh.col_from_l0 else 1] > 1:
                sh.col_ref_idx = r.ue()
                if sh.col_ref_idx >= sh.num_ref[0 if sh.col_from_l0 else 1]:
                    raise ValueError("corrupt HEVC slice header: collocated_ref_idx out of range")
        if (pps["weighted_pred"] and not b) or (pps["weighted_bipred"] and b):
            sh.weights = _pred_weight_table(r, sh)
        sh.max_merge = 5 - r.ue()
        if not 1 <= sh.max_merge <= 5:
            raise ValueError("corrupt HEVC slice header: five_minus_max_num_merge_cand out of "
                             "range")
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
    """The NAL unit header and slice segment header of ``sh``, through
    byte_alignment(), as bytes (no emulation prevention yet)."""
    w = BitWriter().u(1, 0).u(6, sh.nal_type).u(6, 0).u(3, sh.temporal_id + 1)
    w.u(1, int(sh.first))
    if BLA_W_LP <= sh.nal_type <= 23:
        w.u(1, int(sh.no_output_of_prior_pics))
    w.ue(sh.pps_id)
    if not sh.first:
        if pps["dependent_slices"]:
            w.u(1, 0)
        w.u(_bits_for(sps["ctbs_w"] * sps["ctbs_h"]), sh.address)
    w.u(pps["extra_bits"], 0)
    w.ue(sh.slice_type)
    if pps["output_flag"]:
        w.u(1, int(sh.pic_output))
    if not sh.idr:
        w.u(sps["log2_max_poc_lsb"], sh.poc_lsb)
        sets = sps["st_rps"]
        w.u(1, int(sh.rps_idx >= 0))
        if sh.rps_idx < 0:
            _write_st_ref_pic_set(w, len(sets), sets, sh.rps)
        elif len(sets) > 1:
            w.u(_bits_for(len(sets)), sh.rps_idx)
        if sps["long_term"]:
            _write_long_term_entries(w, sps, sh.long_term)
        if sps["temporal_mvp"]:
            w.u(1, int(sh.tmvp))
    if sps["sao"]:
        w.u(1, int(sh.sao_luma)).u(1, int(sh.sao_chroma))
    if sh.slice_type != I_SLICE:
        b = sh.slice_type == B_SLICE
        w.u(1, int(sh.ref_override))
        if sh.ref_override:
            w.ue(sh.num_ref[0] - 1)
            if b:
                w.ue(sh.num_ref[1] - 1)
        total = num_pic_total_curr(sh)
        if pps["lists_modification"] and total > 1:
            for l in range(2 if b else 1):
                entries = sh.list_entry[l]
                w.u(1, int(entries is not None))
                for e in entries or ():
                    w.u(_bits_for(total), e)
        if b:
            w.u(1, int(sh.mvd_l1_zero))
        if pps["cabac_init_present"]:
            w.u(1, int(sh.cabac_init))
        if sh.tmvp:
            if b:
                w.u(1, int(sh.col_from_l0))
            if sh.num_ref[0 if sh.col_from_l0 else 1] > 1:
                w.ue(sh.col_ref_idx)
        if (pps["weighted_pred"] and not b) or (pps["weighted_bipred"] and b):
            _write_pred_weight_table(w, sh)
        w.ue(5 - sh.max_merge)
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


def _write_ptl(w: BitWriter, max_sub_layers: int = 1) -> None:
    w.u(2, 0).u(1, 0).u(5, MAIN_PROFILE).u(32, 0x60000000)   # Main, compatible with Main 10
    w.u(4, 0b1001).u(44, 0).u(8, LEVEL)            # progressive, frame only
    if max_sub_layers > 1:                         # no sub-layer profile or level
        w.u(2 * (max_sub_layers - 1), 0).u(2 * (9 - max_sub_layers), 0)


def _write_ordering(w: BitWriter, max_sub_layers: int, dpb: int, reorder: int) -> None:
    w.u(1, 1)                                      # sub_layer_ordering_info_present_flag
    for _ in range(max_sub_layers):
        w.ue(dpb - 1).ue(reorder).ue(0)


def encode_vps(max_sub_layers: int = 1, dpb: int = 1, reorder: int = 0) -> bytes:
    w = BitWriter().u(4, 0).u(2, 3).u(6, 0).u(3, max_sub_layers - 1)
    w.u(1, int(max_sub_layers == 1)).u(16, 0xFFFF)
    _write_ptl(w, max_sub_layers)
    _write_ordering(w, max_sub_layers, dpb, reorder)
    w.u(6, 0).ue(0).u(1, 0).u(1, 0)                # layer sets, timing, extension
    return nal_unit(VPS_NUT, w.align(True))


def encode_sps(width: int, height: int, *, ctb_log2: int = 4, min_cb_log2: int = 3,
               bit_depth: int = 8, chroma_format: int = 1, scaling_list: bool = False,
               min_tb_log2: int = 2, max_tb_log2: int = 4, max_depth_intra: int = 1,
               max_depth_inter: int = 0, amp: bool = False,
               pcm: Optional[Tuple[int, int, int, int, bool]] = None, sao: bool = True,
               log2_max_poc_lsb: int = 8, st_rps: Sequence[Rps] = (),
               temporal_mvp: bool = False, max_sub_layers: int = 1, dpb: int = 1,
               reorder: int = 0, long_term: Optional[Sequence[Tuple[int, bool]]] = None,
               range_extension: bool = False,
               window: Tuple[int, int, int, int] = (0, 0, 0, 0), full_range: bool = False,
               matrix: Optional[int] = None) -> bytes:
    """An SPS (Main, 4:2:0, 8-bit) of ``width`` x ``height`` coded samples
    (multiples of the smallest coding block), cropped by ``window`` (left,
    right, top, bottom in chroma samples); ``pcm`` = (luma bits, chroma
    bits, smallest log2 size, largest log2 size, pcm_loop_filter_disabled);
    ``st_rps`` the short-term reference picture sets (each predicted from
    the one before where it can be); ``dpb`` and ``reorder`` each sub-layer's
    sps_max_dec_pic_buffering and sps_max_num_reorder_pics; ``long_term``
    (not None) sets long_term_ref_pics_present_flag with these (POC LSB,
    used) candidates. A VUI is written
    when the range or the matrix is given. ``bit_depth``, ``chroma_format``,
    ``scaling_list`` (default lists) and ``range_extension`` (an
    sps_range_extension() of zero flags) write sequences the decoder
    refuses."""
    w = BitWriter().u(4, 0).u(3, max_sub_layers - 1).u(1, int(max_sub_layers == 1))
    _write_ptl(w, max_sub_layers)
    w.ue(0).ue(chroma_format)
    if chroma_format == 3:
        w.u(1, 0)                                  # separate_colour_plane_flag
    w.ue(width).ue(height)
    w.u(1, int(any(window)))
    if any(window):
        for v in window:
            w.ue(v)
    w.ue(bit_depth - 8).ue(bit_depth - 8).ue(log2_max_poc_lsb - 4)
    _write_ordering(w, max_sub_layers, dpb, reorder)
    w.ue(min_cb_log2 - 3).ue(ctb_log2 - min_cb_log2).ue(min_tb_log2 - 2)
    w.ue(max_tb_log2 - min_tb_log2).ue(max_depth_inter).ue(max_depth_intra)
    w.u(1, int(scaling_list))
    if scaling_list:
        w.u(1, 0)                                  # sps_scaling_list_data_present_flag
    w.u(1, int(amp)).u(1, int(sao)).u(1, int(pcm is not None))
    if pcm is not None:
        bits_y, bits_c, lo, hi, no_filter = pcm
        w.u(4, bits_y - 1).u(4, bits_c - 1).ue(lo - 3).ue(hi - lo).u(1, int(no_filter))
    w.ue(len(st_rps))
    for i, rps in enumerate(st_rps):
        _write_st_ref_pic_set(w, i, st_rps, rps)
    w.u(1, int(long_term is not None))
    if long_term is not None:
        w.ue(len(long_term))
        for lsb, used in long_term:
            w.u(log2_max_poc_lsb, lsb).u(1, int(used))
    w.u(1, int(temporal_mvp)).u(1, 1)             # strong_intra_smoothing_enabled_flag
    vui = full_range or matrix is not None
    w.u(1, int(vui))
    if vui:
        w.u(1, 0).u(1, 0).u(1, 1).u(3, 5).u(1, int(full_range))
        w.u(1, int(matrix is not None))
        if matrix is not None:
            w.u(8, 2).u(8, 2).u(8, matrix)
        w.u(1, 0).u(3, 0).u(1, 0).u(1, 0).u(1, 0)
    w.u(1, int(range_extension))                   # sps_extension_present_flag
    if range_extension:
        w.u(1, 1).u(7, 0).u(9, 0)                  # sps_range_extension(), its flags 0
    return nal_unit(SPS_NUT, w.align(True))


def encode_pps(*, init_qp: int = 26, sign_hiding: bool = False, transform_skip: bool = False,
               wpp: bool = False, tiles: bool = False,
               cu_qp_delta_depth: Optional[int] = None, cb_qp_offset: int = 0,
               cr_qp_offset: int = 0, slice_chroma_offsets: bool = False,
               transquant_bypass: bool = False, across_slices: bool = True,
               deblocking: Optional[Tuple[bool, bool, int, int]] = None,
               dependent_slices: bool = False, output_flag: bool = False,
               cabac_init_present: bool = False, num_ref_default: Tuple[int, int] = (1, 1),
               weighted_pred: bool = False, weighted_bipred: bool = False,
               lists_modification: bool = False, parallel_merge_log2: int = 2) -> bytes:
    """A PPS; ``cu_qp_delta_depth`` None turns cu_qp_delta off;
    ``deblocking`` = (override enabled, disabled, beta_offset_div2,
    tc_offset_div2) writes the deblocking control fields; ``wpp`` and
    ``tiles`` write a PPS the decoder refuses."""
    w = BitWriter().ue(0).ue(0).u(1, int(dependent_slices)).u(1, int(output_flag))
    w.u(3, 0).u(1, int(sign_hiding)).u(1, int(cabac_init_present))
    w.ue(num_ref_default[0] - 1).ue(num_ref_default[1] - 1).se(init_qp - 26)
    w.u(1, 0).u(1, int(transform_skip)).u(1, int(cu_qp_delta_depth is not None))
    if cu_qp_delta_depth is not None:
        w.ue(cu_qp_delta_depth)
    w.se(cb_qp_offset).se(cr_qp_offset).u(1, int(slice_chroma_offsets))
    w.u(1, int(weighted_pred)).u(1, int(weighted_bipred)).u(1, int(transquant_bypass))
    w.u(1, int(tiles)).u(1, int(wpp))
    if tiles:                                      # two uniformly spaced columns, one row
        w.ue(1).ue(0).u(1, 1).u(1, 1)
    w.u(1, int(across_slices)).u(1, int(deblocking is not None))
    if deblocking is not None:
        override, disabled, beta, tc = deblocking
        w.u(1, int(override)).u(1, int(disabled))
        if not disabled:
            w.se(beta).se(tc)
    w.u(1, 0).u(1, int(lists_modification)).ue(parallel_merge_log2 - 2).u(1, 0).u(1, 0)
    return nal_unit(PPS_NUT, w.align(True))


# ---------------------------------------------------------------------------
# The native coding tree layer.
# ---------------------------------------------------------------------------

_STATUS = {-1: "bad arguments", -2: "a slice that runs past its end",
           -3: "coding tree units past the picture's end, or decoded twice",
           -4: "a cu_qp_delta out of range", -5: "a coefficient out of range or a last "
           "position outside its block", -6: "an encoder output buffer too small",
           -7: "a picture whose slices leave coding tree units undecoded"}
MAX_REFS, REF_INTS, COL_INTS = 16, 9, 9
PARAM_INTS, SAO_INTS = 26, 24
SLICE_INTS = 23 + 2 * MAX_REFS * REF_INTS
KNOBS = ("best", "split_cu", "bypass", "pcm", "nxn", "split_tu", "transform_skip", "qp_delta",
         "dead_zone", "chroma_dm", "max_level", "inter", "skip", "part", "amp", "merge", "bi",
         "mv_range", "search")
# The contexts (hevc_tables.h's Context), by syntax element: (name, first
# ctxIdx, count); those of P and B slices after I slices'.
CONTEXTS = (("sao_merge", 0, 1), ("sao_type_idx", 1, 1), ("split_cu_flag", 2, 3),
            ("cu_transquant_bypass_flag", 5, 1), ("cu_qp_delta_abs", 6, 2),
            ("part_mode", 8, 1), ("prev_intra_luma_pred_flag", 9, 1),
            ("intra_chroma_pred_mode", 10, 1), ("split_transform_flag", 11, 3),
            ("cbf_luma", 14, 2), ("cbf_chroma", 16, 4), ("transform_skip_flag", 20, 2),
            ("last_sig_coeff_x_prefix", 22, 18), ("last_sig_coeff_y_prefix", 40, 18),
            ("coded_sub_block_flag", 58, 4), ("sig_coeff_flag", 62, 42),
            ("coeff_abs_level_greater1_flag", 104, 24),
            ("coeff_abs_level_greater2_flag", 128, 6), ("cu_skip_flag", 134, 3),
            ("pred_mode_flag", 137, 1), ("part_mode_inter", 138, 3), ("merge_flag", 141, 1),
            ("merge_idx", 142, 1), ("inter_pred_idc", 143, 5), ("ref_idx", 148, 2),
            ("abs_mvd_greater0_flag", 150, 1), ("abs_mvd_greater1_flag", 151, 1),
            ("mvp_flag", 152, 1), ("rqt_root_cbf", 153, 1))
NUM_CONTEXTS, INTRA_CONTEXTS = 154, 134
# What the native encoder counts (its Stat order): I slices' paths, then
# those of P and B slices.
INTRA_STAT_NAMES = tuple(
    [f"luma_mode_{s}x{s}_{m}" for s in (4, 8, 16, 32) for m in range(35)]
    + [f"chroma_mode_{m}" for m in range(5)]
    + ["chroma_mode_34", "nxn", "pcm", "transquant_bypass", "transform_skip", "sign_hidden",
       "cu_qp_delta_nonzero", "cu_qp_delta_suffix", "dst", "dct_4", "dct_8", "dct_16", "dct_32",
       "scan_horizontal", "scan_vertical", "strong_intra_smoothing", "reference_filter", "mpm",
       "rem_intra_mode", "sao_band", "sao_edge_0", "sao_edge_90", "sao_edge_135", "sao_edge_45",
       "sao_merge_left", "sao_merge_up", "level_escape", "rice_4", "coded_sub_block_0",
       "chroma_4x4_at_blk3", "qp_pred_in_ctb"])
STAT_NAMES = INTRA_STAT_NAMES + tuple(
    ["cu_skip", "intra_in_inter", "part_2NxN", "part_Nx2N", "part_NxN", "part_2NxnU",
     "part_2NxnD", "part_nLx2N", "part_nRx2N"] + [f"merge_idx_{k}" for k in range(5)]
    + ["amvp", "pred_l0", "pred_l1", "pred_bi", "bi_to_l0_8x4", "mvp_1", "mvd_l1_zero",
       "ref_idx_1", "ref_idx_bypass", "mvd_escape", "merge_temporal", "merge_combined",
       "merge_zero", "amvp_temporal", "tmvp_scaled", "amvp_scaled", "weighted_uni",
       "weighted_bi", "rqt_root_cbf_0", "inter_split", "cbf_luma_inferred", "mc_frac_both",
       "mc_outside", "single_mcl", "mer_excluded", "inter_bypass"])
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
    if (lib.hive_hevc_param_ints(), lib.hive_hevc_slice_ints(), lib.hive_hevc_col_ints()) != \
            (PARAM_INTS, SLICE_INTS, COL_INTS):
        raise RuntimeError("the native HEVC decoder's parameters do not match _params")
    return lib


def _pointers(*arrays) -> ctypes.Array:
    return (ctypes.c_void_p * max(1, len(arrays)))(*(a.ctypes.data for a in arrays))


def contexts_reachable() -> np.ndarray:
    """The contexts ((3, NUM_CONTEXTS) bools, by initType) that Main
    profile pictures can read: I slices (initType 0) all of theirs but the
    luma last-position prefix's third (its 4x4 blocks take contexts 0 and 1,
    8x8 ones 3-5); P and B slices (initTypes 1 and 2) every context but
    that third."""
    reach = np.zeros((3, NUM_CONTEXTS), bool)
    reach[0, :INTRA_CONTEXTS] = True
    reach[1:] = True
    for first in (22, 40):
        reach[:, first + 2] = False
    return reach


def stat_counts() -> Tuple[int, int]:
    named, filters = ctypes.c_int32(0), ctypes.c_int32(0)
    total = _lib().hive_hevc_stat_counts(ctypes.byref(named), ctypes.byref(filters))
    if (named.value, filters.value) != (len(STAT_NAMES), len(FILTER_NAMES)):
        raise RuntimeError("the native HEVC encoder's counts do not match STAT_NAMES")
    return total, filters.value


def _params(sps: dict, pps: dict, poc: int = 0) -> np.ndarray:
    pcm = sps["pcm"]
    return np.array([sps["coded_width"], sps["coded_height"], sps["ctb_log2"], sps["min_cb_log2"],
                     sps["min_tb_log2"], sps["max_tb_log2"], sps["max_depth_intra"], pcm,
                     *(sps["pcm_bits"] if pcm else (8, 8)),
                     sps["pcm_min_log2"] if pcm else 0, sps["pcm_max_log2"] if pcm else 0,
                     sps["pcm_no_filter"] if pcm else 0, sps["sao"], sps["strong_smoothing"],
                     pps["sign_hiding"], pps["transform_skip"], pps["cu_qp_delta"],
                     pps["cu_qp_delta_depth"], pps["cb_qp_offset"], pps["cr_qp_offset"],
                     pps["transquant_bypass"], sps["max_depth_inter"], sps["amp"],
                     pps["parallel_merge_log2"], poc], np.int32)


def _slice_params(sh: SliceHeader, pps: dict, lists=((), ()), ctbs: int = 0) -> np.ndarray:
    """The native slice parameters: the header's fields and, for each list,
    each entry's (slot, POC, long-term, luma w, o, Cb w, o, Cr w, o);
    ``lists`` holds (slot, POC, long-term) triples."""
    out = np.zeros(SLICE_INTS, np.int32)
    weighted = sh.slice_type != I_SLICE and bool(
        pps["weighted_bipred"] if sh.slice_type == B_SLICE else pps["weighted_pred"])
    table = sh.weights or WeightTable()
    out[:23] = [sh.address, pps["init_qp"] + sh.qp_delta, sh.sao_luma, sh.sao_chroma,
                sh.cb_offset, sh.cr_offset, sh.deblocking_off, sh.beta_div2, sh.tc_div2,
                sh.across, ctbs, sh.slice_type, sh.num_ref[0], sh.num_ref[1], sh.mvd_l1_zero,
                sh.init_type, sh.tmvp, sh.col_from_l0, sh.col_ref_idx, sh.max_merge, weighted,
                table.luma_denom, table.chroma_denom]
    refs = out[23:].reshape(2, MAX_REFS, REF_INTS)
    for l, entries in enumerate(lists):
        for i, (slot, poc, long_term) in enumerate(entries):
            refs[l, i, :3] = slot, poc, long_term
            refs[l, i, 3:] = table.values(l, i)
    return out


# ---------------------------------------------------------------------------
# The decoder.
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class Picture:
    """A decoded picture: its planes cropped to the conformance window
    (views of the coded ones), and what the output order needs; for the
    pictures after it, the coded planes and the motion field. Pictures
    compare by identity."""

    poc: int
    irap: bool
    flush: bool                 # an IRAP picture with NoRaslOutputFlag: the output flushes
    y: Optional[np.ndarray] = None
    u: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None
    sample: int = -1            # the MP4 sample it came from, if the caller says
    output: bool = True         # pic_output_flag
    discard: bool = False       # the flush drops the pictures not yet output
    planes: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    field: Optional[np.ndarray] = None
    long_term: bool = False     # marked "used for long-term reference"
    held: tuple = ()            # the POCs of the reference pictures the DPB holds beside it


@dataclass
class PictureState:
    """What decoding a picture's slices needs beyond their headers: the
    parameter sets, the picture (its POC), the DPB pictures its lists may
    name (the native slots), each slice's lists as (slot, POC) pairs, and
    the collocated picture."""

    sps: dict
    pps: dict
    picture: Picture
    refs: List[Picture]
    lists: List[Tuple[List[Tuple[int, int, bool]], List[Tuple[int, int, bool]]]]
    col: Optional[Picture]


class HevcDecoder:
    """Decodes access units (lists of NAL units, emulation prevention still
    in) in decode order with :meth:`decode`; :func:`output_order` puts
    the pictures in the order FFmpeg outputs them.
    With ``pixels`` False it reads only the headers (:func:`scan_track`).
    ``filter_stats`` (len(FILTER_NAMES) int64), when given, counts the loop
    filters' decisions. The decoded picture buffer keeps the pictures each
    picture's reference picture set keeps, short- and long-term (8.3.2);
    the RASL pictures of an IRAP picture with NoRaslOutputFlag (an IDR or
    BLA picture, the first of the stream, or the first after an end of
    sequence) are dropped, as FFmpeg drops them, and such a picture with
    no_output_of_prior_pics_flag (which FFmpeg sets on a CRA picture after
    an end of sequence) drops the pictures not yet output."""

    def __init__(self, pixels: bool = True, filter_stats: Optional[np.ndarray] = None):
        self.pixels = pixels
        self.vps: Dict[int, dict] = {}
        self.sps: Dict[int, dict] = {}
        self.pps: Dict[int, dict] = {}
        self.prev_tid0_poc = 0
        self.first = True
        self.no_rasl = True         # NoRaslOutputFlag of the last IRAP picture
        self.size: Optional[Tuple[int, int]] = None
        self.filter_stats = filter_stats
        self.dpb: List[Picture] = []
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
        state = self.begin([sh for _, sh in slices])
        if state is None:
            return None
        return self.finish(state, slices)

    def begin(self, headers: List[SliceHeader]) -> Optional[PictureState]:
        """A picture's POC (8.3.1), its reference picture set applied to the
        DPB (8.3.2) and its slices' lists (8.3.4), from its slice headers;
        None for no slices and for a RASL picture that is dropped."""
        if not headers:
            return None
        first = headers[0]
        if not first.first:
            raise ValueError("an HEVC access unit whose first slice segment does not start its "
                             "picture")
        if any(sh.first for sh in headers[1:]):
            raise ValueError("an HEVC access unit holds more than one picture")
        if any((sh.nal_type, sh.poc_lsb, sh.rps, sh.long_term, sh.tmvp) !=
               (first.nal_type, first.poc_lsb, first.rps, first.long_term, first.tmvp)
               for sh in headers[1:]):
            raise ValueError("corrupt HEVC picture: its slices differ in NAL unit type, POC, "
                             "reference picture set or temporal vector prediction")
        pps = self.pps[first.pps_id]
        sps = self.sps[pps["sps_id"]]
        if self.size is not None and self.size != (sps["coded_width"], sps["coded_height"]):
            raise _refuse("a change of picture size within the stream", STREAM_ITEM)
        self.size = (sps["coded_width"], sps["coded_height"])
        after_eos = self.first
        if first.irap:
            self.no_rasl = first.idr or first.bla or self.first
        self.first = False
        if first.rasl and self.no_rasl:
            return None
        no_rasl = first.irap and self.no_rasl
        poc = self._poc(first, sps, no_rasl)
        picture = Picture(poc=poc, irap=first.irap, flush=no_rasl, output=first.pic_output,
                          discard=no_rasl and (first.no_output_of_prior_pics or (
                              first.nal_type == CRA_NUT and after_eos)))
        if no_rasl:
            self.dpb = []
        rps = () if first.idr else first.rps
        # The long-term pictures first (from every reference picture, by the
        # whole POC or its LSBs), then the short-term ones.
        max_lsb = 1 << sps["log2_max_poc_lsb"]
        long_term, long_used = [], []
        for lsb, used, present, cycle, _ in first.long_term:
            want = lsb + (poc - cycle * max_lsb - (poc & (max_lsb - 1)) if present else 0)
            found = [p for p in self.dpb if (p.poc if present else p.poc & (max_lsb - 1)) == want]
            if found:
                long_term.append(found[0])
                if used:
                    long_used.append(found[0])
            elif used:
                raise ValueError(f"corrupt HEVC stream: picture {poc} refers to a long-term "
                                 f"picture the decoded picture buffer does not hold")
        for p in long_term:
            p.long_term = True
        keep = {poc + d for d, _ in rps}
        self.dpb = [p for p in self.dpb if p in long_term or (not p.long_term and p.poc in keep)]
        by_poc = {p.poc: p for p in self.dpb if not p.long_term}
        current = []
        for group in ([d for d, used in rps if used and d < 0],
                      [d for d, used in rps if used and d > 0]):
            pics = []
            for d in group:
                if poc + d not in by_poc:
                    raise ValueError(f"corrupt HEVC stream: picture {poc} refers to picture "
                                     f"{poc + d}, which the decoded picture buffer does not "
                                     f"hold")
                pics.append(by_poc[poc + d])
            current.append(pics)
        before, after = current
        refs = list(self.dpb)
        picture.held = tuple(p.poc for p in refs)
        slot = {id(p): k for k, p in enumerate(refs)}
        lists, col = [], None
        for sh in headers:
            pair = []
            for l in range(2):
                n = sh.num_ref[l]
                chosen = ref_list(before, after, n, sh.list_entry[l], l, long_used)
                pair.append([(slot[id(p)], p.poc, p.long_term) for p in chosen])
                if sh.tmvp and l == (0 if sh.col_from_l0 else 1) and n:
                    pic = chosen[sh.col_ref_idx]
                    if col is not None and pic is not col:
                        raise ValueError("corrupt HEVC picture: its slices name different "
                                         "collocated pictures")
                    col = pic
            lists.append(tuple(pair))
        return PictureState(sps, pps, picture, refs, lists, col)

    def finish(self, state: PictureState, slices: List[Tuple[bytes, SliceHeader]]) -> Picture:
        """Decode the picture's slices (their RBSPs, in the order of
        ``begin``'s headers) given ``begin``'s state, and keep the picture
        in the DPB."""
        sps, pps, picture = state.sps, state.pps, state.picture
        self.dpb.append(picture)
        if not self.pixels:
            return picture
        lib = _lib()
        width, height = sps["coded_width"], sps["coded_height"]
        planes = (np.empty((height, width), np.uint8),
                  *(np.empty((height // 2, width // 2), np.uint8) for _ in range(2)))
        order = sorted(range(len(slices)), key=lambda k: slices[k][1].address)
        slices = [slices[k] for k in order]
        lists = [state.lists[k] for k in order]
        slice_params = np.stack([_slice_params(sh, pps, lst) for (_, sh), lst in
                                 zip(slices, lists)])
        buffers = [np.frombuffer(rbsp[sh.data_offset:] + bytes(16), np.uint8)
                   for rbsp, sh in slices]
        sizes = np.array([len(b) - 16 for b in buffers], np.int64)
        field = np.zeros(((height + 15) // 16) * ((width + 15) // 16) * COL_INTS, np.int32)
        stats = self.filter_stats
        refs = [plane for p in state.refs for plane in p.planes]
        status = lib.hive_hevc_decode_picture(
            _params(sps, pps, picture.poc).ctypes.data, len(slices), slice_params.ctypes.data,
            _pointers(*buffers), sizes.ctypes.data, _pointers(*planes),
            _pointers(*refs) if refs else None, len(state.refs),
            state.col.field.ctypes.data if state.col is not None else None, field.ctypes.data,
            stats.ctypes.data if stats is not None else None)
        if status:
            raise ValueError(f"corrupt HEVC picture: {_STATUS.get(status, status)}")
        picture.planes, picture.field = planes, field
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
        if sh.temporal_id == 0 and not RADL_N <= sh.nal_type <= RASL_R and \
                not sh.sub_layer_non_reference:
            self.prev_tid0_poc = poc
        return poc


def scan_track(parameter_sets: List[bytes], num_samples: int,
               read: Callable[[int], List[bytes]]) -> Tuple[dict, int, List[int], np.ndarray,
                                                            np.ndarray]:
    """The stream's first SPS, its reorder depth, the samples that hold
    IRAP pictures, whether each sample gives a frame in :func:`output_order`
    (not a dropped RASL picture, one with pic_output_flag 0, nor one a flush
    discards) and, for each RASL sample, the IRAP sample it leads (-1 for
    the others), after reading every sample's headers in decode order
    (``read(i)``: the NAL units of sample ``i``): refuses, before any
    picture is decoded, what the decoder does not decode, and an output
    order that leaves two pictures between flushes out of POC order."""
    decoder = HevcDecoder(pixels=False)
    for unit in parameter_sets:
        decoder._parameter_set(unit)
    pictures, irap = [], []
    leads = np.full(num_samples, -1, np.int64)
    segment = 0
    for i in range(num_samples):
        slices = decoder.headers(read(i))
        if slices and slices[0][1].rasl and irap:
            leads[i] = irap[-1]
        picture = decoder.picture(slices)
        if picture is not None:
            segment += picture.flush
            picture.sample = i
            pictures.append((segment, picture))
            if picture.irap:
                irap.append(i)
    if not decoder.sps:
        raise ValueError("the HEVC stream carries no sequence parameter set")
    sps = next(iter(decoder.sps.values()))
    segments = {p.sample: k for k, p in pictures}
    shown = list(output_order((p for _, p in pictures), sps))
    if any(segments[a.sample] == segments[b.sample] and a.poc >= b.poc
           for a, b in zip(shown, shown[1:])):
        raise _refuse(f"pictures whose POCs FFmpeg's output order (sps_max_num_reorder_pics "
                      f"{sps['reorder']}, sps_max_dec_pic_buffering "
                      f"{sps['max_dec_pic_buffering']}) does not sort", STREAM_ITEM)
    frames = np.zeros(num_samples, bool)
    frames[[p.sample for p in shown]] = True
    return sps, sps["reorder"], irap, frames, leads


def output_order(pictures: Iterable[Picture], sps: dict) -> Iterator[Picture]:
    """The pictures (in decode order) in the order FFmpeg's hevc decoder
    outputs them (``ff_hevc_output_frames``): an IRAP picture with
    NoRaslOutputFlag first outputs, or with ``discard`` drops, every picture
    pending; a picture with pic_output_flag 0 is never pending; then, with
    each picture added, the lowest POC pending goes out while more than
    ``sps_max_num_reorder_pics`` are pending or the DPB (the reference
    pictures, those pending and the current one) holds more than
    ``sps_max_dec_pic_buffering`` (at least the reorder depth + 1); at the
    end, every picture pending."""
    reorder = sps["reorder"]
    dpb = max(sps["max_dec_pic_buffering"], reorder + 1)
    heap: list = []
    for count, picture in enumerate(pictures):
        if picture.flush:
            while heap and not picture.discard:
                yield heapq.heappop(heap)[2]
            heap = []
        if picture.output:
            heapq.heappush(heap, (picture.poc, count, picture))
        while heap:
            # Within a flush segment POCs name pictures one to one.
            held = set(picture.held) | {e[0] for e in heap} | {picture.poc}
            if len(heap) <= reorder and len(held) <= dpb:
                break
            yield heapq.heappop(heap)[2]
    while heap:
        yield heapq.heappop(heap)[2]


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
    """One slice: its CTBs and header fields; in P and B slices, the
    lists' sizes (None: the PPS's defaults), their modification
    (list_entry_lX, None: none), mvd_l1_zero_flag, cabac_init_flag, the
    collocated picture (collocated_from_l0, collocated_ref_idx), the
    explicit weights and MaxNumMergeCand."""

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
    slice_type: int = I_SLICE
    num_ref: Optional[Tuple[int, int]] = None
    list_entry: Tuple[Optional[Tuple[int, ...]], Optional[Tuple[int, ...]]] = (None, None)
    mvd_l1_zero: bool = False
    cabac_init: bool = False
    col_from_l0: bool = True
    col_ref_idx: int = 0
    weights: Optional[WeightTable] = None
    max_merge: int = 5


@dataclass
class PicturePlan:
    """One picture: its NAL unit type, slices, the knobs of the native
    planner (KNOBS) and its seed, and each CTB's SAO parameters ((CTBs,
    SAO_INTS) int8: type of Y, Cb, Cr (0 off, 1 band, 2 edge; -1 / -2 in
    Y's place a merge left / up), edge class, band position, then four
    offsets of each component); the pictures it predicts from (display
    indices) and those of them it marks long-term (they stay so), its
    TemporalId, pic_output_flag, slice_temporal_mvp_enabled_flag, whether
    its reference picture set is coded in its slice headers even where the
    SPS holds it, whether its long-term entries carry their POC's MSBs where
    the LSBs alone would do, and an IRAP picture's
    no_output_of_prior_pics_flag."""

    nal_type: int
    slices: List[SlicePlan]
    knobs: Dict[str, int]
    seed: int
    sao: Optional[np.ndarray] = None
    refs: Sequence[int] = ()
    long_term: Sequence[int] = ()
    temporal_id: int = 0
    output: bool = True
    tmvp: bool = False
    rps_in_header: bool = False
    lt_msb: bool = False
    no_output_of_prior_pics: bool = False


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


@dataclass
class GopPicture:
    """A picture's place in a group of pictures: its NAL unit type,
    TemporalId, the pictures it predicts from (display indices, nearest
    first), those of them that are long-term references, whether it is a B
    picture (between two anchors) and whether later pictures predict from
    it."""

    nal_type: int
    temporal_id: int = 0
    refs: Tuple[int, ...] = ()
    b: bool = False
    reference: bool = True
    long_term: Tuple[int, ...] = ()


class GopStructure:
    """The pictures of a clip with B pictures, as x265 codes them: an IDR
    picture, then anchors every ``bframes`` + 1 pictures and on the clip's
    last, each a P picture predicting from the ``max_refs`` anchors before it
    since the last IRAP picture (with ``long_term``, that IRAP picture too,
    as a long-term reference once it falls out of the ``max_refs``), or
    (``choose(anchor)`` -> "cra" / "bla" / "idr") an IRAP picture; the B
    pictures between two anchors coded after the later one, predicting from
    both and, where there are two or more, from their middle one (a
    reference coded first: a pyramid). Before a CRA anchor the B pictures are its leading pictures:
    RASL (``open_gop``, predicting across it) or RADL (from it alone);
    before a BLA anchor (BLA_W_RADL) RADL pictures; before an IDR anchor P
    pictures in display order. With ``sub_layers`` the B pictures have
    TemporalId 1 (the middle one TSA_R or STSA_R, the others TSA_N, STSA_N
    or TRAIL_N, by anchor and display index)."""

    def __init__(self, n: int, bframes: int, *, max_refs: int = 1,
                 open_gop: bool = True, sub_layers: bool = False, long_term: bool = False,
                 choose: Callable[[int], str] = lambda k: "p"):
        self.pictures: Dict[int, GopPicture] = {}
        self.order: List[int] = []
        step = bframes + 1
        anchors = sorted(set(range(0, n, step)) | {n - 1})
        self.pictures[0] = GopPicture(IDR_W_RADL)
        self.order.append(0)
        held = [0]                                    # anchors since the last IRAP
        marked: set = set()                           # long-term references
        for a, b in zip(anchors[:-1], anchors[1:]):
            kind = choose(b)
            between = list(range(a + 1, b))
            if kind == "idr":
                for k in between:                     # P pictures, in display order
                    self.pictures[k] = GopPicture(TRAIL_R, refs=(k - 1,),
                                                  long_term=tuple({k - 1} & marked))
                    self.order.append(k)
                self.pictures[b] = GopPicture(IDR_N_LP)
                self.order.append(b)
                held, marked = [b], set()
                continue
            if kind in ("cra", "bla"):
                self.pictures[b] = GopPicture(CRA_NUT if kind == "cra" else BLA_W_RADL)
                leading = RASL_N if open_gop and kind == "cra" else RADL_N
            else:
                refs = tuple(reversed(held[-max_refs:]))
                if long_term and held[0] not in refs:
                    marked.add(held[0])
                    refs += (held[0],)
                self.pictures[b] = GopPicture(TRAIL_R, refs=refs,
                                              long_term=tuple(r for r in refs if r in marked))
                leading = None
            self.order.append(b)
            middle = a + (b - a) // 2 if len(between) > 1 else None
            coded = ([middle] if middle is not None else []) + [k for k in between if k != middle]
            for k in coded:
                pic = GopPicture(TRAIL_N, b=True, reference=k == middle)
                if leading is None:
                    pic.refs = (a, b)
                    if sub_layers:
                        pic.temporal_id = 1
                        pic.nal_type = ((TSA_R, STSA_R)[b // step % 2] if k == middle else
                                        (TSA_N, STSA_N, TRAIL_N)[k % 3])
                    elif k == middle:
                        pic.nal_type = TRAIL_R
                elif leading == RASL_N:
                    pic.refs = (a, b)
                    pic.nal_type = RASL_R if k == middle else RASL_N
                else:
                    pic.refs = (b,)
                    pic.nal_type = RADL_R if k == middle else RADL_N
                if middle is not None and k != middle:
                    pic.refs = pic.refs + (middle,)
                pic.refs = tuple(sorted(pic.refs, key=lambda r: (abs(r - k), r)))
                pic.long_term = tuple(r for r in pic.refs if r in marked)
                self.pictures[k] = pic
                self.order.append(k)
            if kind in ("cra", "bla"):
                held, marked = [b], set()
            else:
                held.append(b)


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
    zone and the largest level. ``knobs`` override the defaults.

    With ``inter`` (GopStructure's options, and "slices": which inter slice
    fields vary among "types" (I and P slices in P pictures, P and I
    slices in B pictures, B slices in P pictures), "num_ref",
    "modification", "weights", "mvd_l1_zero", "cabac_init", "collocated",
    "max_merge", "tmvp_off", "output_off", "rps_in_header", "lt_msb",
    "prior_pics") the pictures follow a :class:`GopStructure` whose anchors
    are seeded P, CRA (a share ``bla`` of them BLA) or IDR pictures, and the
    native planner's inter knobs apply: the shares of inter, skipped, split
    (and AMP) and merged units, bi-prediction, the vectors' range."""

    def __init__(self, width: int, height: int, seed: int, *, ctb_log2: int = 4,
                 idr_every: int = 100, cra: float = 0.2, max_slices: int = 3, qp: int = 30,
                 slice_options: Sequence[str] = ("qp", "sao", "deblocking", "across"),
                 knobs: Optional[Dict[str, int]] = None, inter: Optional[dict] = None,
                 bla: float = 0.0):
        self.width, self.height, self.seed, self.ctb_log2 = width, height, seed, ctb_log2
        self.idr_every, self.cra, self.max_slices, self.qp = idr_every, cra, max_slices, qp
        self.bla = bla
        self.slice_options = set(slice_options)
        self.knobs = dict(split_cu=500, bypass=60, pcm=60, nxn=400, split_tu=500,
                          transform_skip=300, qp_delta=6, dead_zone=400, chroma_dm=300,
                          max_level=4000)
        self.inter = dict(inter) if inter is not None else None
        if self.inter is not None:
            self.knobs.update(inter=850, skip=150, part=350, amp=400, merge=400, bi=450,
                              mv_range=96)
            self.inter_slices = set(self.inter.pop("slices", ()))
        self.knobs.update(knobs or {})
        self.gop: Optional[GopStructure] = None

    def decode_order(self, n: int) -> List[int]:
        if self.inter is None:
            return list(range(n))

        def choose(k: int) -> str:
            if k % self.idr_every == 0:
                return "idr"
            roll = np.random.default_rng([self.seed, k, 3]).random()
            if roll >= self.cra:
                return "p"
            return "bla" if roll < self.cra * self.bla else "cra"

        self.gop = GopStructure(n, choose=choose, **self.inter)
        return self.gop.order

    def __call__(self, index: int, sps: dict, pps: dict) -> PicturePlan:
        rng = np.random.default_rng([self.seed, index])
        if self.gop is not None:
            gop = self.gop.pictures[index]
            kind = gop.nal_type
        elif index % self.idr_every == 0:
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
        plan = PicturePlan(kind, slices, dict(self.knobs), int(rng.integers(0, 2 ** 62)), sao)
        if self.gop is not None and gop.refs:
            self._inter_plan(plan, gop, index, sps, pps)
        elif self.gop is not None:
            plan.temporal_id = gop.temporal_id
            plan.no_output_of_prior_pics = index > 0 and "prior_pics" in self.inter_slices and \
                kind in (IDR_N_LP, BLA_W_RADL) and bool(
                    np.random.default_rng([self.seed, index, 1]).random() < 0.5)
        return plan

    def _inter_plan(self, plan: PicturePlan, gop: GopPicture, index: int, sps: dict,
                    pps: dict) -> None:
        """The inter fields of a picture that predicts from others: its
        slices' types, lists, weights and merge candidates, its collocated
        picture, TemporalId and output flag."""
        rng = np.random.default_rng([self.seed, index, 1])
        options = self.inter_slices
        plan.refs, plan.temporal_id, plan.long_term = gop.refs, gop.temporal_id, gop.long_term
        plan.lt_msb = "lt_msb" in options and rng.random() < 0.5
        plan.tmvp = not ("tmvp_off" in options and rng.random() < 0.35)
        plan.rps_in_header = "rps_in_header" in options and rng.random() < 0.3
        plan.output = not ("output_off" in options and pps["output_flag"] and
                           not gop.reference and rng.random() < 0.3)
        total = len(gop.refs)
        short = [r for r in gop.refs if r not in gop.long_term]
        before = sorted((r for r in short if r < index), reverse=True)
        after = sorted(r for r in short if r > index)
        long_term = [r for r in gop.refs if r in gop.long_term]
        col = short[int(rng.integers(0, len(short)))]         # the collocated picture
        for s in plan.slices:
            kind = B_SLICE if gop.b else P_SLICE
            if "types" in options:
                roll = rng.random()
                if roll < 0.1:
                    kind = I_SLICE
                elif roll < 0.3:
                    kind = P_SLICE if gop.b else B_SLICE
            s.slice_type = kind
            if kind == I_SLICE:
                continue
            lists = 2 if kind == B_SLICE else 1
            if "num_ref" in options:
                s.num_ref = tuple(int(rng.integers(1, total + 2)) if l < lists else 0
                                  for l in range(2))
            num_ref = s.num_ref or (pps["num_ref_default"][0],
                                    pps["num_ref_default"][1] if lists == 2 else 0)
            if "modification" in options and pps["lists_modification"] and total > 1:
                s.list_entry = tuple(
                    tuple(int(v) for v in rng.integers(0, total, num_ref[l]))
                    if l < lists and rng.random() < 0.6 else None for l in range(2))
            s.mvd_l1_zero = "mvd_l1_zero" in options and rng.random() < 0.3
            s.cabac_init = "cabac_init" in options and rng.random() < 0.5
            if "max_merge" in options:
                s.max_merge = int(rng.integers(1, 6))
            if "weights" in options and (pps["weighted_bipred"] if kind == B_SLICE
                                         else pps["weighted_pred"]):
                table = WeightTable(luma_denom=int(rng.integers(0, 8)))
                table.chroma_denom = int(rng.integers(0, 8))
                for l in range(lists):
                    for _ in range(num_ref[l]):
                        table.luma[l].append((int(rng.integers(-20, 21)), int(rng.integers(
                            -30, 31))) if rng.random() < 0.6 else None)
                        table.chroma[l].append(tuple((int(rng.integers(-20, 21)), int(
                            rng.integers(-60, 61))) for _ in range(2))
                                               if rng.random() < 0.5 else None)
                s.weights = table
            # The collocated picture in the lists this slice has.
            s.col_from_l0 = kind == P_SLICE or not ("collocated" in options and
                                                    rng.random() < 0.5)
            found = None
            for l in ((0, 1) if s.col_from_l0 else (1, 0))[:lists]:
                entries = ref_list(before, after, num_ref[l], s.list_entry[l], l, long_term)
                if col in entries:
                    found = (l, entries.index(col))
                    break
            if found is None:
                s.list_entry = (None, None)
                s.num_ref = (max(num_ref[0], total), max(num_ref[1], total) if lists == 2 else 0)
                found = (0, ref_list(before, after, s.num_ref[0], None, 0, long_term).index(col))
            s.col_from_l0, s.col_ref_idx = found[0] == 0, found[1]


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


class InterPlanner:
    """Plans for a real clip shaped as x265 codes one at its ``medium``
    preset (CTU 64, ``--bframes 4 --b-pyramid --ref 3 --open-gop
    --weightp --max-merge 3``, TMVP, SAO, sign hiding; its parameter sets are
    ``write_hevc_mp4``'s options): an IDR picture, CRA pictures every
    ``cra_every`` whose leading B pictures are RASL pictures, P anchors every
    BFRAMES + 1 pictures predicting from up to REFS anchors before them, and
    the B pictures between two anchors in a pyramid (:class:`GopStructure`);
    ``slices`` slices of equal CTB counts, QP ``qp`` (B pictures ``qp`` +
    B_OFFSET), list 0 the pictures before and list 1 those after, the
    weight tables written with every flag 0 (x265 weights only fades),
    MaxNumMergeCand MAX_MERGE; each inter unit of 16x16, merged or
    searched (SEARCH whole samples, then half and quarter samples) to the
    nearest prediction, and the IRAP pictures and SAO as
    :class:`IntraPlanner`'s."""

    BFRAMES, REFS, B_OFFSET, MAX_MERGE, SEARCH = 4, 3, 2, 3, 2

    def __init__(self, width: int, height: int, *, qp: int = 27, slices: int = 1,
                 cra_every: int = 250):
        self.width, self.height, self.qp = width, height, qp
        self.slices, self.cra_every = slices, cra_every
        self.intra = IntraPlanner(width, height, qp=qp, slices=slices)
        self.gop: Optional[GopStructure] = None

    def decode_order(self, n: int) -> List[int]:
        self.gop = GopStructure(n, self.BFRAMES, max_refs=self.REFS,
                                choose=lambda k: "cra" if k % self.cra_every == 0 else "p")
        return self.gop.order

    def __call__(self, index: int, sps: dict, pps: dict) -> PicturePlan:
        gop = self.gop.pictures[index]
        plan = self.intra(index, sps, pps)
        plan.nal_type = gop.nal_type
        if not gop.refs:
            return plan
        plan.refs, plan.tmvp = gop.refs, True
        plan.knobs = dict(best=1, search=self.SEARCH, dead_zone=450, max_level=32767)
        before = [r for r in gop.refs if r < index]
        after = [r for r in gop.refs if r > index]
        for s in plan.slices:
            s.slice_type = B_SLICE if gop.b else P_SLICE
            s.qp_delta += self.B_OFFSET if gop.b else 0
            if gop.b:
                s.num_ref = (max(1, len(before)), max(1, len(after)))
                s.col_from_l0 = False
            else:
                s.num_ref = (len(before), 0)
            s.max_merge = self.MAX_MERGE
            s.weights = WeightTable() if not gop.b else None
        return plan


def reference_sets(order: Sequence[int], plans: Dict[int, PicturePlan]
                   ) -> Dict[int, Tuple[Rps, Tuple[Tuple[int, bool], ...]]]:
    """Each picture's reference picture set (display index -> the
    short-term set, deltas in display order, and the long-term pictures as
    (display index, used) from the nearest): the pictures it predicts from,
    used, and those decoded before it that a later picture predicts from,
    kept; a picture marked long-term (``PicturePlan.long_term``) stays so;
    none across an IDR or BLA picture."""
    last_use: Dict[int, int] = {}
    for i, k in enumerate(order):
        for r in plans[k].refs:
            last_use[r] = i
    sets, held, marked = {}, [], set()
    for i, k in enumerate(order):
        plan = plans[k]
        if plan.nal_type in (IDR_W_RADL, IDR_N_LP, BLA_W_LP, BLA_W_RADL, BLA_N_LP):
            held, marked = [], set()
        missing = [r for r in plan.refs if r not in held]
        if missing:
            raise ValueError(f"HEVC picture {k} predicts from {missing}, which are not held")
        marked |= set(plan.long_term)
        kept = [r for r in held if last_use.get(r, -1) > i or r in plan.refs]
        sets[k] = (_sorted_rps((r - k, r in plan.refs) for r in kept if r not in marked),
                   tuple((r, r in plan.refs) for r in sorted(kept, key=lambda r: -r)
                         if r in marked))
        held = [r for r in kept if last_use.get(r, -1) > i] + [k]
    return sets


def _coded_planes(planes, width: int, height: int):
    def pad(p, rows, cols):
        h, w = p.shape
        return np.ascontiguousarray(np.pad(p, ((0, rows - h), (0, cols - w)), mode="edge"))

    y, u, v = planes
    return pad(y, height, width), pad(u, height // 2, width // 2), pad(v, height // 2, width // 2)


def write_hevc_mp4(path: str, frames: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                   planner: Callable[[int, dict, dict], PicturePlan], *,
                   ctb_log2: int = 4, min_cb_log2: int = 3, max_tb_log2: int = 4,
                   max_depth_intra: int = 1, max_depth_inter: int = 0, amp: bool = False,
                   pcm: Optional[Tuple[int, int, int, int, bool]] = None, sao: bool = True,
                   log2_max_poc_lsb: int = 8, temporal_mvp: bool = False, rps_in_sps: int = 0,
                   lt_in_sps: int = 0, max_sub_layers: int = 1,
                   extra_window: Tuple[int, int, int, int] = (0, 0, 0, 0), init_qp: int = 26,
                   sign_hiding: bool = False, transform_skip: bool = False,
                   cu_qp_delta_depth: Optional[int] = None, cb_qp_offset: int = 0,
                   cr_qp_offset: int = 0, slice_chroma_offsets: bool = False,
                   transquant_bypass: bool = False, across_slices: bool = True,
                   deblocking: Optional[Tuple[bool, bool, int, int]] = None,
                   output_flag: bool = False, cabac_init_present: bool = False,
                   num_ref_default: Tuple[int, int] = (1, 1), weighted_pred: bool = False,
                   weighted_bipred: bool = False, lists_modification: bool = False,
                   parallel_merge_log2: int = 2, dpb: Optional[int] = None,
                   fourcc: bytes = b"hvc1", in_band: bool = False) -> dict:
    """Write ``frames`` (uint8 Y, U, V planes in display order, an even
    size; may be lazy) as an HEVC MP4 at 30 fps, each picture as
    ``planner(display index, sps, pps)`` plans it (:class:`Exerciser`,
    :class:`IntraPlanner`, :class:`InterPlanner`), in the planner's
    ``decode_order(n)`` where it gives one. The coded size is the frame's
    rounded up to the smallest coding block, cropped back by the
    conformance window (plus ``extra_window``, in chroma samples). Each
    picture's reference picture set keeps what later pictures predict from
    (:func:`reference_sets`); the first ``rps_in_sps`` distinct short-term
    sets, and the first ``lt_in_sps`` distinct long-term (POC LSB, used)
    pairs, go in the SPS. Pictures out of display order get ``ctts`` and an edit list that
    starts at the first frame; the SPS's reorder depth and DPB size are
    what the order needs (``dpb``: a smaller DPB size, so that FFmpeg's
    output bumps pictures from a full DPB). The other SPS and PPS options are
    :func:`encode_sps` and :func:`encode_pps`'s. ``fourcc`` b"hev1" with
    ``in_band`` repeats the parameter sets in each IRAP sample. Returns the
    counts of :data:`STAT_NAMES` over the file, the contexts' decisions by
    initType (``contexts``) and counts of the picture-level paths."""
    from hive_tpu_torch.video.h264 import reorder_depth

    height, width = frames[0][0].shape
    n = len(frames)
    cb = 1 << min_cb_log2
    coded_w, coded_h = -(-width // cb) * cb, -(-height // cb) * cb
    left, right, top, bottom = extra_window
    window = (left, right + (coded_w - width) // 2, top, bottom + (coded_h - height) // 2)
    sps_options = dict(ctb_log2=ctb_log2, min_cb_log2=min_cb_log2, max_tb_log2=max_tb_log2,
                       max_depth_intra=max_depth_intra, max_depth_inter=max_depth_inter, amp=amp,
                       pcm=pcm, sao=sao, log2_max_poc_lsb=log2_max_poc_lsb,
                       temporal_mvp=temporal_mvp, max_sub_layers=max_sub_layers, window=window)
    pps_unit = encode_pps(init_qp=init_qp, sign_hiding=sign_hiding, transform_skip=transform_skip,
                          cu_qp_delta_depth=cu_qp_delta_depth, cb_qp_offset=cb_qp_offset,
                          cr_qp_offset=cr_qp_offset, slice_chroma_offsets=slice_chroma_offsets,
                          transquant_bypass=transquant_bypass, across_slices=across_slices,
                          deblocking=deblocking, output_flag=output_flag,
                          cabac_init_present=cabac_init_present, num_ref_default=num_ref_default,
                          weighted_pred=weighted_pred, weighted_bipred=weighted_bipred,
                          lists_modification=lists_modification,
                          parallel_merge_log2=parallel_merge_log2)
    # The plans first (they fix the reference picture sets, which the SPS
    # carries), against the SPS without its sets.
    draft = HevcDecoder(pixels=False)
    draft.decode([encode_vps(), encode_sps(coded_w, coded_h, **sps_options), pps_unit])
    planned = getattr(planner, "decode_order", None)
    order = list(planned(n)) if planned is not None else list(range(n))
    plans = {k: planner(k, draft.sps[0], draft.pps[0]) for k in range(n)}
    if plans[order[0]].nal_type not in (IDR_W_RADL, IDR_N_LP):
        raise ValueError("an HEVC stream starts with an IDR picture")
    sets = reference_sets(order, plans)
    sps_sets: List[Rps] = []
    lt_sps: List[Tuple[int, bool]] = []
    max_lsb = 1 << log2_max_poc_lsb
    for k in order:
        st, lt = sets[k]
        if st and st not in sps_sets and len(sps_sets) < rps_in_sps:
            sps_sets.append(st)
        for r, used in lt:
            if (r % max_lsb, used) not in lt_sps and len(lt_sps) < lt_in_sps:
                lt_sps.append((r % max_lsb, used))
    reordered = order != list(range(n))
    reorder = reorder_depth(order) if reordered else 0
    dpb = dpb or min(16, max(len(st) + len(lt) for st, lt in sets.values()) + reorder + 1)
    vps_unit = encode_vps(max_sub_layers, dpb, reorder)
    sps_unit = encode_sps(coded_w, coded_h, st_rps=sps_sets, dpb=dpb, reorder=reorder,
                          long_term=lt_sps if any(lt for _, lt in sets.values()) else None,
                          **sps_options)
    decoder = HevcDecoder()
    decoder.decode([vps_unit, sps_unit, pps_unit])
    sps, pps = decoder.sps[0], decoder.pps[0]
    lib = _lib()
    total_stats, _ = stat_counts()
    totals = np.zeros(total_stats, np.int64)
    counts = dict.fromkeys(("pictures", "idr_w_radl", "idr_n_lp", "cra", "trail_r", "trail_n",
                            "tsa_n", "tsa_r", "stsa_n", "stsa_r", "radl_n", "radl_r", "rasl_n",
                            "rasl_r", "slices", "multi_slice_pictures", "slice_qp_varies",
                            "slice_sao_off", "slice_chroma_offsets", "deblocking_override",
                            "deblocking_off_slices", "deblocking_offsets", "across_off",
                            "poc_msb_wrap", "sao_ctbs", "p_slices", "b_slices",
                            "i_slices_in_inter_pictures", "rps_from_sps", "rps_in_header",
                            "rps_predicted", "ref_override", "list_modification", "mvd_l1_zero",
                            "cabac_init", "collocated_from_l1", "collocated_ref_idx",
                            "weight_tables", "max_merge_below_5", "tmvp_off_pictures",
                            "bla_w_radl", "long_term_entries", "long_term_used",
                            "long_term_msb", "long_term_from_sps", "prior_pics_dropped",
                            "output_off", "sub_layer_1"), 0)
    names = {IDR_W_RADL: "idr_w_radl", IDR_N_LP: "idr_n_lp", CRA_NUT: "cra", TRAIL_R: "trail_r",
             TRAIL_N: "trail_n", TSA_N: "tsa_n", TSA_R: "tsa_r", STSA_N: "stsa_n",
             STSA_R: "stsa_r", RADL_N: "radl_n", RADL_R: "radl_r", RASL_N: "rasl_n",
             RASL_R: "rasl_r", BLA_W_RADL: "bla_w_radl"}
    sync: List[bool] = []

    def long_term_entries(k: int, idr_display: int, lt, decoded: List[int], plan: PicturePlan):
        """The header's long-term entries: each picture's POC LSBs, with
        their MSB cycle where another picture decoded since the last IDR or
        BLA picture shares them or the plan asks; those the SPS's candidates
        give first."""
        entries = []
        for r, used in lt:
            lsb = (r - idr_display) % max_lsb
            present = plan.lt_msb or any((d - idr_display) % max_lsb == lsb
                                         for d in decoded if d != r)
            cycle = ((k - idr_display) - (k - idr_display) % max_lsb
                     - ((r - idr_display) - lsb)) // max_lsb
            idx = lt_sps.index((lsb, used)) if (lsb, used) in lt_sps else -1
            entries.append((lsb, used, present, cycle, idx))
        return tuple(e for e in entries if e[4] >= 0) + tuple(e for e in entries if e[4] < 0)

    def samples() -> Iterator[bytes]:
        idr_display, decoded = 0, []
        for k in order:
            plan = plans[k]
            if plan.nal_type in (IDR_W_RADL, IDR_N_LP):
                idr_display = k
            if plan.nal_type in (IDR_W_RADL, IDR_N_LP, BLA_W_LP, BLA_W_RADL, BLA_N_LP):
                decoded = []
            source = _coded_planes(frames[k], coded_w, coded_h)
            recon = tuple(np.zeros_like(p) for p in source)
            rps, lt = sets[k]
            long_term = long_term_entries(k, idr_display, lt, decoded, plan)
            decoded.append(k)
            predicted = rps in sps_sets and not plan.rps_in_header
            headers = []
            for number, s in enumerate(plan.slices):
                inter = s.slice_type != I_SLICE
                default = (pps["num_ref_default"][0],
                           pps["num_ref_default"][1] if s.slice_type == B_SLICE else 0)
                num_ref = (s.num_ref or default) if inter else (0, 0)
                sh = SliceHeader(plan.nal_type, first=number == 0, address=s.first_ctb,
                                 slice_type=s.slice_type, pic_output=plan.output,
                                 poc_lsb=(k - idr_display) % max_lsb, rps=rps,
                                 rps_idx=sps_sets.index(rps) if predicted else -1,
                                 long_term=long_term,
                                 no_output_of_prior_pics=plan.no_output_of_prior_pics,
                                 tmvp=plan.tmvp and bool(sps["temporal_mvp"]),
                                 sao_luma=s.sao_luma and sps["sao"],
                                 sao_chroma=s.sao_chroma and sps["sao"], num_ref=num_ref,
                                 ref_override=inter and num_ref != default,
                                 list_entry=s.list_entry if inter else (None, None),
                                 mvd_l1_zero=s.mvd_l1_zero and s.slice_type == B_SLICE,
                                 cabac_init=s.cabac_init and bool(pps["cabac_init_present"]),
                                 col_from_l0=s.col_from_l0 or s.slice_type != B_SLICE,
                                 col_ref_idx=s.col_ref_idx, weights=s.weights,
                                 max_merge=s.max_merge, qp_delta=s.qp_delta,
                                 cb_offset=s.cb_offset, cr_offset=s.cr_offset,
                                 deblocking_override=s.deblocking_override,
                                 deblocking_off=s.deblocking_off if s.deblocking_override
                                 else bool(pps["deblocking_off"]),
                                 beta_div2=s.beta_div2 if s.deblocking_override
                                 else pps["beta_div2"],
                                 tc_div2=s.tc_div2 if s.deblocking_override else pps["tc_div2"],
                                 across=s.across if pps["across_slices"] else False,
                                 temporal_id=plan.temporal_id)
                if not (sh.sao_luma or sh.sao_chroma or not sh.deblocking_off):
                    sh.across = bool(pps["across_slices"])
                if inter and not (pps["lists_modification"] and num_pic_total_curr(sh) > 1):
                    sh.list_entry = (None, None)
                if not sh.tmvp:
                    sh.col_from_l0, sh.col_ref_idx = True, 0
                headers.append(sh)
                counts["slice_sao_off"] += not (sh.sao_luma and sh.sao_chroma)
                counts["slice_chroma_offsets"] += bool(s.cb_offset or s.cr_offset)
                counts["deblocking_override"] += s.deblocking_override
                counts["deblocking_off_slices"] += sh.deblocking_off
                counts["deblocking_offsets"] += bool(sh.beta_div2 or sh.tc_div2)
                counts["across_off"] += not sh.across
                counts["p_slices"] += sh.slice_type == P_SLICE
                counts["b_slices"] += sh.slice_type == B_SLICE
                counts["i_slices_in_inter_pictures"] += not inter and any(
                    o.slice_type != I_SLICE for o in plan.slices)
                counts["ref_override"] += sh.ref_override
                counts["list_modification"] += any(e is not None for e in sh.list_entry)
                counts["mvd_l1_zero"] += sh.mvd_l1_zero
                counts["cabac_init"] += sh.cabac_init
                counts["collocated_from_l1"] += sh.tmvp and not sh.col_from_l0
                counts["collocated_ref_idx"] += sh.tmvp and sh.col_ref_idx > 0
                counts["weight_tables"] += inter and sh.weights is not None
                counts["max_merge_below_5"] += inter and sh.max_merge < 5
            counts["slice_qp_varies"] += len({s.qp_delta for s in plan.slices}) > 1
            state = decoder.begin(headers)
            header_bytes = [np.frombuffer(write_slice_header(sh, sps, pps), np.uint8)
                            for sh in headers]
            slice_params = np.stack([_slice_params(sh, pps, lists, s.count) for sh, lists, s in
                                     zip(headers, state.lists, plan.slices)])
            sao_table = plan.sao if plan.sao is not None else \
                np.zeros((sps["ctbs_w"] * sps["ctbs_h"], SAO_INTS), np.int8)
            sao_table = np.ascontiguousarray(sao_table, np.int8)
            counts["sao_ctbs"] += int((sao_table[:, 0] != 0).sum())
            capacity = 4096 + 2 * coded_w * coded_h * 3
            out = np.empty(capacity, np.uint8)
            sizes = np.zeros(len(plan.slices), np.int64)
            knobs = knob_array(plan.knobs)
            refs = [plane for p in state.refs for plane in p.planes]
            size = lib.hive_hevc_encode_picture(
                _params(sps, pps, state.picture.poc).ctypes.data, len(plan.slices),
                slice_params.ctypes.data, knobs.ctypes.data, ctypes.c_uint64(plan.seed),
                _pointers(*source), _pointers(*recon), _pointers(*header_bytes),
                np.array([len(h) for h in header_bytes], np.int64).ctypes.data,
                sao_table.ctypes.data, out.ctypes.data, capacity, sizes.ctypes.data,
                totals.ctypes.data, _pointers(*refs) if refs else None, len(state.refs),
                state.col.field.ctypes.data if state.col is not None else None)
            if size < 0:
                raise ValueError(f"HEVC picture encode failed: {_STATUS.get(int(size), size)}")
            units, at = [], 0
            for length in sizes.tolist():
                rbsp = out[at:at + length]
                units.append(bytes(rbsp[:2]) + escape(rbsp[2:]).tobytes())
                at += length
            # Decoded as a reader will, for the pictures that predict from it.
            decoder.finish(state, decoder.headers(units))
            irap = BLA_W_LP <= plan.nal_type <= CRA_NUT
            if in_band and irap:
                units = [vps_unit, sps_unit, pps_unit] + units
            sync.append(irap)
            counts["pictures"] += 1
            counts[names[plan.nal_type]] += 1
            counts["slices"] += len(plan.slices)
            counts["multi_slice_pictures"] += len(plan.slices) > 1
            counts["poc_msb_wrap"] += k - idr_display >= max_lsb
            if rps:
                counts["rps_from_sps" if predicted else "rps_in_header"] += 1
                counts["rps_predicted"] += not predicted and bool(sps_sets)
            counts["tmvp_off_pictures"] += bool(sps["temporal_mvp"]) and not plan.tmvp and any(
                s.slice_type != I_SLICE for s in plan.slices)
            counts["output_off"] += not plan.output
            counts["long_term_entries"] += len(long_term)
            counts["long_term_used"] += sum(e[1] for e in long_term)
            counts["long_term_msb"] += sum(e[2] for e in long_term)
            counts["long_term_from_sps"] += sum(e[4] >= 0 for e in long_term)
            counts["prior_pics_dropped"] += plan.no_output_of_prior_pics
            counts["sub_layer_1"] += plan.temporal_id > 0
            yield b"".join(len(u).to_bytes(4, "big") + u for u in units)

    # Decode times are the decode index; composition times the display
    # index, as many frames later as the order needs (ctts stays >= 0).
    delay = max(i - k for i, k in enumerate(order))
    cts_offsets = [k + delay - i for i, k in enumerate(order)] if reordered else None
    edits = [(n, delay)] if reordered else ()
    entry = mp4.visual_entry(fourcc, width, height,
                             mp4.box(b"hvcC", hvcc_record(vps_unit, sps_unit, pps_unit)))
    mp4.write_mp4(path, entry, samples(), width=width, height=height, timescale=30,
                  durations=[1] * n, cts_offsets=cts_offsets, sync=sync, edits=edits)
    result = dict(zip(STAT_NAMES, totals[:len(STAT_NAMES)].tolist()))
    result.update(counts)
    result["contexts"] = totals[len(STAT_NAMES):].reshape(3, NUM_CONTEXTS)
    return result
