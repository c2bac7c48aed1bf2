"""HEVC input of hive_tpu_torch (``video/hevc.py``, ``native/src/hevc_decode.cpp``)
against cv2 5.0.0, whose bundled FFmpeg decodes HEVC: the ``hvcC`` record,
the parameter sets and the conformance window, PCM pictures (lossless, so
the seeded planes come back exactly), the refusals by ROADMAP sub-item, the
native library's absence, the constant tables against FFmpeg's copies, and
the video adaptor's JPEG bytes against ``hive_tpu``'s (which reads the file
through cv2). cv2 writes no HEVC here: every file is the port's writer's.
All comparisons are exact."""

import glob
import os
import re
from os.path import join as pjoin

import cv2
import numpy as np
import pytest

from hive_tpu_torch import native
from hive_tpu_torch.video import hevc, mp4
from hive_tpu_torch.video.capture import VideoCapture
from tests.test_torch_mpeg4 import assert_reads_as_cv2, scene_planes


def seeded_planes(num_frames, width, height, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (height, width), dtype=np.uint8),
             rng.integers(0, 256, (height // 2, width // 2), dtype=np.uint8),
             rng.integers(0, 256, (height // 2, width // 2), dtype=np.uint8))
            for _ in range(num_frames)]


PCM_ONLY = dict(pcm=1000, nxn=0, split_cu=400)


def write_pcm_clip(path, frames, width, height, **options):
    """Every coding unit PCM (8-bit samples, CUs of 8 to 16), the loop
    filters off for them (SAO off: FFmpeg's SAO leaves unfiltered PCM chroma
    alone only in a CTB's top left quarter, PERF.md): lossless."""
    hevc.write_hevc_mp4(str(path), frames,
                        hevc.Exerciser(width, height, 1, knobs=PCM_ONLY, max_slices=2),
                        pcm=(8, 8, 3, 4, True), sao=False, **options)


# ---------------------------------------------------------------------------
# The container and the parameter sets.
# ---------------------------------------------------------------------------

def test_hvcc_record_round_trips_and_arrays_parse():
    """hvcc_record's VPS / SPS / PPS arrays come back from parse_hvcc with
    the NAL length size; a record with an extra array (SEI) and two units
    in one array parses too; a short or wrong-version record is corrupt."""
    vps, sps, pps = hevc.encode_vps(), hevc.encode_sps(64, 48), hevc.encode_pps()
    record = hevc.hvcc_record(vps, sps, pps)
    assert len(record) == 23 + 3 * 5 + len(vps) + len(sps) + len(pps)
    assert record[1] == hevc.MAIN_PROFILE and record[12] == hevc.LEVEL
    assert hevc.parse_hvcc(record) == (4, [vps, sps, pps])
    sei = bytes([hevc.SEI_PREFIX << 1, 1, 5, 1, 0x80])
    extra = bytearray(record[:22]) + bytes([2])
    extra[21] = (extra[21] & 0xFC) | 1                 # 2-byte lengths
    extra += bytes([0x80 | hevc.SPS_NUT, 0, 2]) + len(sps).to_bytes(2, "big") + sps \
        + len(sps).to_bytes(2, "big") + sps
    extra += bytes([hevc.SEI_PREFIX, 0, 1]) + len(sei).to_bytes(2, "big") + sei
    assert hevc.parse_hvcc(bytes(extra)) == (2, [sps, sps, sei])
    for bad in (record[:20], b"\x02" + record[1:]):
        with pytest.raises(ValueError, match="corrupt hvcC"):
            hevc.parse_hvcc(bad)


def test_parameter_sets_parse_as_written():
    """Each field the writer sets reads back: sizes, the window in chroma
    units, block sizes, PCM, the VUI's range and matrix; the PPS's QP,
    offsets and flags; a slice header's fields and its data's byte."""
    sps = hevc.parse_sps(mp4_rbsp(hevc.encode_sps(
        104, 64, ctb_log2=5, min_cb_log2=3, max_tb_log2=4, max_depth_intra=2,
        pcm=(7, 5, 3, 4, True), window=(0, 2, 0, 3), full_range=True, matrix=1,
        log2_max_poc_lsb=6)))
    assert (sps["coded_width"], sps["coded_height"], sps["width"], sps["height"]) == \
        (104, 64, 100, 58)
    assert (sps["ctb_log2"], sps["min_cb_log2"], sps["min_tb_log2"], sps["max_tb_log2"],
            sps["max_depth_intra"], sps["ctbs_w"], sps["ctbs_h"]) == (5, 3, 2, 4, 2, 4, 2)
    assert (sps["pcm_bits"], sps["pcm_min_log2"], sps["pcm_max_log2"], sps["pcm_no_filter"]) \
        == ((7, 5), 3, 4, 1)
    assert (sps["full_range"], sps["matrix"], sps["log2_max_poc_lsb"], sps["ptl"]["profile"]) \
        == (True, 1, 6, hevc.MAIN_PROFILE)
    hevc.check_sps(sps)
    pps = hevc.parse_pps(mp4_rbsp(hevc.encode_pps(
        init_qp=31, sign_hiding=True, transform_skip=True, cu_qp_delta_depth=1,
        cb_qp_offset=-3, cr_qp_offset=5, slice_chroma_offsets=True, transquant_bypass=True,
        across_slices=False, deblocking=(True, False, -2, 3))))
    assert (pps["init_qp"], pps["sign_hiding"], pps["transform_skip"], pps["cu_qp_delta"],
            pps["cu_qp_delta_depth"], pps["cb_qp_offset"], pps["cr_qp_offset"],
            pps["slice_chroma_offsets"], pps["transquant_bypass"], pps["across_slices"],
            pps["deblocking_override"], pps["beta_div2"], pps["tc_div2"]) == \
        (31, 1, 1, 1, 1, -3, 5, 1, 1, 0, 1, -2, 3)
    hevc.check_pps(pps)
    sh = hevc.SliceHeader(hevc.TRAIL_R, first=False, address=5, poc_lsb=9, sao_luma=True,
                          qp_delta=-4, cb_offset=2, cr_offset=-1, deblocking_override=True,
                          beta_div2=4, tc_div2=-6)
    sps["sao"] = 1
    rbsp = hevc.write_slice_header(sh, sps, pps) + b"\xAB"
    got = hevc.parse_slice_header(rbsp, {0: sps}, {0: pps})
    assert (got.address, got.poc_lsb, got.sao_luma, got.sao_chroma, got.qp_delta,
            got.cb_offset, got.cr_offset, got.beta_div2, got.tc_div2) == \
        (5, 9, True, False, -4, 2, -1, 4, -6)
    assert rbsp[got.data_offset] == 0xAB


def mp4_rbsp(nal):
    return hevc._rbsp(nal)


@pytest.mark.parametrize("size, window", [((64, 48), (0, 0, 0, 0)), ((100, 58), (0, 0, 0, 0)),
                                          ((96, 64), (0, 1, 3, 2))],
                         ids=["aligned", "cropped_to_size", "extra_window"])
def test_pcm_pictures_are_lossless_and_cropped_as_cv2_crops(tmp_path, size, window):
    """PCM pictures of a size that is not a multiple of the smallest coding
    block (coded 104x64, cropped back), or with a window beyond it: cv2's
    size and frames equal the port's, and both equal the seeded planes
    cropped by the window."""
    width, height = size
    frames = seeded_planes(3, width, height, 4)
    frames[1][0][:] = 0                               # zero runs: emulation prevention
    path = tmp_path / "pcm.mp4"
    write_pcm_clip(path, frames, width, height, extra_window=window)
    left, right, top, bottom = window
    crop = (width - 2 * (left + right), height - 2 * (top + bottom))
    capture, got = assert_reads_as_cv2(path, count=3)
    assert (capture.width, capture.height) == crop
    for planes, want in zip(VideoCapture(str(path), device="cpu").planes(), frames):
        for k, (plane, full) in enumerate(zip(planes, want)):
            s = 1 if k == 0 else 2
            crop_plane = full[2 * top // s:full.shape[0] - 2 * bottom // s,
                              2 * left // s:full.shape[1] - 2 * right // s]
            np.testing.assert_array_equal(plane.numpy(), crop_plane)


def test_pcm_of_fewer_bits_and_hev1_in_band_sets_read_as_cv2(tmp_path):
    """PCM samples of 6 (luma) and 5 (chroma) bits, and an hev1 track whose
    IRAP samples carry the parameter sets: cv2's frames."""
    path = tmp_path / "hev1.mp4"
    hevc.write_hevc_mp4(str(path), scene_planes(4, 64, 48),
                        hevc.Exerciser(64, 48, 2, knobs=dict(pcm=500), idr_every=2, cra=0.5),
                        pcm=(6, 5, 3, 4, False), fourcc=b"hev1", in_band=True)
    assert mp4.read_track(str(path)).fourcc == b"hev1"
    assert_reads_as_cv2(path, count=4)


# ---------------------------------------------------------------------------
# Refusals, each naming its ROADMAP sub-item.
# ---------------------------------------------------------------------------

def intra_units(tmp_path, frames=2):
    """A small all-intra clip's parameter sets and samples (NAL units)."""
    path = tmp_path / "intra.mp4"
    hevc.write_hevc_mp4(str(path), scene_planes(frames, 64, 48), hevc.IntraPlanner(64, 48))
    track = mp4.read_track(str(path))
    length, units = hevc.parse_hvcc(track.config)
    with open(path, "rb") as f:
        samples = []
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            samples.append(mp4.split_nal_units(f.read(int(size)), length))
    return units, samples


def write_units(path, units, samples, fourcc=b"hvc1"):
    vps, sps, pps = units
    entry = mp4.visual_entry(fourcc, 64, 48, mp4.box(b"hvcC", hevc.hvcc_record(vps, sps, pps)))
    mp4.write_mp4(str(path), entry,
                  [b"".join(len(u).to_bytes(4, "big") + u for u in s) for s in samples],
                  width=64, height=48, timescale=30, durations=[1] * len(samples),
                  sync=[True] + [False] * (len(samples) - 1))


def refusal_clip(tmp_path, case, fourcc=b"hvc1"):
    units, samples = intra_units(tmp_path)
    vps, sps, pps = units
    if case == "tiles":
        pps = hevc.encode_pps(tiles=True)
    elif case == "chroma_444":
        sps = hevc.encode_sps(64, 48, chroma_format=3)
    elif case == "range_extension":
        sps = hevc.encode_sps(64, 48, range_extension=True)
    elif case == "main10":
        sps = hevc.encode_sps(64, 48, bit_depth=10)
    elif case == "chroma_422":
        sps = hevc.encode_sps(64, 48, chroma_format=2)
    elif case == "scaling_lists":
        sps = hevc.encode_sps(64, 48, scaling_list=True)
    elif case == "left_crop":
        sps = hevc.encode_sps(64, 48, window=(2, 0, 0, 0))
    elif case == "wpp":
        pps = hevc.encode_pps(wpp=True)
    elif case == "dependent_slices":
        pps = hevc.encode_pps(dependent_slices=True)
        # A second slice segment of the first picture, dependent.
        w = hevc.BitWriter().u(1, 0).u(6, hevc.IDR_W_RADL).u(6, 0).u(3, 1)
        w.u(1, 0).u(1, 0).ue(0).u(1, 1).u(hevc._bits_for(12), 6)
        samples = [samples[0] + [hevc.nal_unit(hevc.IDR_W_RADL, w.align(True)[2:])]]
    path = tmp_path / f"{case}.mp4"
    write_units(path, (vps, sps, pps), samples, fourcc)
    return path


REFUSALS = {
    "tiles": (r"tiles \(tiles_enabled_flag\)", "9c-3"),
    "chroma_444": ("chroma format 4:4:4", "9c-4"),
    "range_extension": ("SPS extensions", "9c-4"),
    "main10": ("10-bit samples", "9c-4"),
    "chroma_422": ("chroma format 4:2:2", "9c-4"),
    "scaling_lists": ("scaling lists", "9c-3"),
    "wpp": ("wavefront parallel processing", "9c-3"),
    "dependent_slices": ("dependent slice segments", "9c-3"),
    "left_crop": ("crops 4 luma columns on the left", "9c-3"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_features_outside_the_subset_are_refused_by_sub_item(tmp_path, case, monkeypatch):
    """Scaling lists, tiles, WPP, dependent slices and a left crop off the
    64-sample grid (9c-3), Main 10, other chroma formats and the range
    extension (9c-4): each refused when the capture opens, before any
    picture is decoded, naming its ROADMAP sub-item."""
    name, item = REFUSALS[case]
    path = refusal_clip(tmp_path, case)
    monkeypatch.setattr(hevc, "_lib", None)
    with pytest.raises(mp4.UnsupportedVideoError,
                       match=f"{name}.*Queue 1 item {re.escape(item)}\\)"):
        VideoCapture(str(path), device="cpu")


def test_without_the_native_library_a_clip_raises_naming_the_build(tmp_path, monkeypatch):
    """No numpy decoder stands beside the native one: the capture opens (its
    headers are read in Python) and the first decode raises, naming the
    failed build."""
    path = tmp_path / "clip.mp4"
    hevc.write_hevc_mp4(str(path), scene_planes(2, 64, 48), hevc.Exerciser(64, 48, 1))
    monkeypatch.setattr(native, "get_native_lib", lambda: None)
    monkeypatch.setattr(native, "_build_error", "g++ -c hevc_decode.cpp did not run")
    capture = VideoCapture(str(path), device="cpu")
    assert capture.frame_count == 2
    with pytest.raises(RuntimeError, match="hevc_decode.cpp.*did not run"):
        capture.frame(0)


# ---------------------------------------------------------------------------
# The constant tables.
# ---------------------------------------------------------------------------

LIBAVCODEC = "libavcodec-*.so.62.28.101"


def header_tables():
    with open(pjoin(os.path.dirname(native.__file__), "src", "hevc_tables.h")) as f:
        text = f.read()
    out = {}
    for name, body in re.findall(r"const \w+ (\w+)(?:\[\w+\])+ = \{(.*?)\};", text, re.S):
        body = re.sub(r"//[^\n]*", "", body)
        out[name] = np.array([int(v) for v in re.findall(r"-?\d+", body)])
    return out


# FFmpeg's init_values[0] holds every context of every slice type; the
# contexts I slices read sit at these indices (hevc_cabac.c's layout), the
# rest hold CNU (154) but for FFmpeg's own: the second bin of
# intra_chroma_pred_mode (19), the range extension's RDPCM flags (49-52) and
# transform-skip significance (135, 136).
FFMPEG_INIT_INDEX = ([0, 1, 2, 3, 4, 5, 9, 10, 13, 17, 18] + list(range(37, 46)) + [47, 48]
                     + list(range(53, 135)) + list(range(137, 167)))
FFMPEG_OTHER_INIT = {19: 139, 49: 139, 50: 139, 51: 139, 52: 139, 135: 141, 136: 111}


def test_tables_equal_those_of_cv2s_libavcodec():
    """hevc_tables.h's tables appear in the libavcodec cv2 5.0.0 loads, as
    FFmpeg lays them out: the contexts' initValues of each initType in
    its rows of init_values (those of I slices where the rest hold CNU in
    the first), the 32x32 transform matrix (int8), the tC and beta
    tables, the intra angles and inverse angles (int32), ctxIdxMap and the
    level scales."""
    found = glob.glob(pjoin(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs",
                            LIBAVCODEC))
    if not found:
        pytest.skip(f"{LIBAVCODEC} (cv2 5.0.0's FFmpeg) is not installed here")
    with open(found[0], "rb") as f:
        lib = f.read()
    tables = header_tables()
    values = tables["kInitValues"].reshape(3, hevc.NUM_CONTEXTS)
    assert len(FFMPEG_INIT_INDEX) == hevc.INTRA_CONTEXTS
    # The contexts P and B slices add, at FFmpeg's indices: cu_skip_flag,
    # pred_mode_flag, part_mode's bins after the first, merge_flag,
    # merge_idx, inter_pred_idc, ref_idx, abs_mvd_greater0 / 1, mvp_lx_flag
    # and rqt_root_cbf (no_residual_data_flag).
    inter_index = [6, 7, 8, 12, 14, 15, 16, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 34, 35, 36]
    init = np.full(167, 154, np.uint8)
    init[FFMPEG_INIT_INDEX] = values[0, :hevc.INTRA_CONTEXTS]
    init[list(FFMPEG_OTHER_INIT)] = list(FFMPEG_OTHER_INIT.values())
    at = lib.find(init.tobytes())
    assert at >= 0
    for init_type in range(3):
        # FFmpeg's rows of init_values are HEVC_CONTEXTS (199) apart.
        row = np.frombuffer(lib[at + 199 * init_type:at + 199 * init_type + 167], np.uint8)
        np.testing.assert_array_equal(row[FFMPEG_INIT_INDEX + inter_index], values[init_type])
    for name, data in (("transform", tables["kTransform"].astype(np.int8).tobytes()),
                       ("tc", tables["kTc"].astype(np.uint8).tobytes()),
                       ("beta", tables["kBeta"].astype(np.uint8).tobytes()),
                       ("angle", tables["kIntraPredAngle"].astype(np.int32).tobytes()),
                       ("inv_angle", tables["kInvAngle"].astype(np.int32).tobytes()),
                       ("ctx_idx_map", tables["kCtxIdxMap"].astype(np.uint8).tobytes()),
                       ("level_scale", tables["kLevelScale"].astype(np.uint8).tobytes()),
                       ("luma_filter", tables["kLumaFilter"][8:].astype(np.int8).tobytes()),
                       ("chroma_filter", tables["kChromaFilter"][4:].astype(np.int8).tobytes())):
        assert lib.find(data) >= 0, name
    # The DST and the chroma QP table are the standard's (FFmpeg computes
    # the DST in code): the DST-VII basis 256 / 3 sin(pi (2k + 1)(n + 1) / 9),
    # rounded.
    k, n = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    np.testing.assert_array_equal(
        tables["kDst"].reshape(4, 4),
        np.round(256 / 3 * np.sin(np.pi * (2 * k + 1) * (n + 1) / 9)).astype(int))
    assert tables["kChromaQp"].tolist() == [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37,
                                            37]


# ---------------------------------------------------------------------------
# Through the video adaptor, against hive_tpu's (cv2).
# ---------------------------------------------------------------------------

def test_video_adaptor_copies_the_frames_hive_tpu_copies(tmp_path):
    """An all-intra HEVC clip (the real-picture planner: CTB 32, SAO and
    deblocking, two slices) through the port's VideoAdaptor and
    hive_tpu's, which reads it with cv2: the same sizes, rate and frames,
    and copy_frames writes the same JPEG bytes."""
    from hive_tpu import dataset_adaptors as jax_adaptors
    from hive_tpu.options import COLMAPOptions as JaxCOLMAPOptions
    from hive_tpu_torch import dataset_adaptors
    from hive_tpu_torch.options import COLMAPOptions
    from tests.test_torch_video_adaptors import VOCAB, same_files

    video = str(tmp_path / "clip.mp4")
    hevc.write_hevc_mp4(video, scene_planes(5, 96, 64),
                        hevc.IntraPlanner(96, 64, qp=30, slices=2, cra_every=2),
                        ctb_log2=5, max_tb_log2=4)
    ours = dataset_adaptors.VideoAdaptor(video, str(tmp_path / "ours"), resize_to=64,
                                         colmap_options=COLMAPOptions(vocab_path=VOCAB),
                                         device="cpu")
    theirs = jax_adaptors.VideoAdaptor(video, str(tmp_path / "theirs"), resize_to=64,
                                       colmap_options=JaxCOLMAPOptions(vocab_path=VOCAB))
    assert (ours.target_width, ours.target_height, ours.num_frames, ours.fps) == \
        (theirs.target_width, theirs.target_height, theirs.num_frames, theirs.fps) == \
        (64, 42, 5, 30.0)
    for index in range(5):
        np.testing.assert_array_equal(ours.get_frame(index), theirs.get_frame(index))
    for adaptor, name in ((ours, "ours_rgb"), (theirs, "theirs_rgb")):
        os.makedirs(tmp_path / name)
        adaptor.copy_frames(str(tmp_path / name), file_extension="jpg")
    same_files(str(tmp_path / "ours_rgb"), str(tmp_path / "theirs_rgb"))
