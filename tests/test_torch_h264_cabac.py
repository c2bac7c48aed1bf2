"""H.264 High profile in hive_tpu_torch (``hive_tpu_torch.video.h264``,
``native/src/h264_decode.cpp``, ``native/src/h264_tables.h``) against
cv2 5.0.0: CABAC (each cabac_init_idc, I_PCM, several slices a picture),
the 8x8 transform (CAVLC's interleaved scans, intra 8x8 prediction, the
deblocking of 8x8 blocks) and scaling matrices (explicit, default, each
fall-back rule), every frame bit-equal to cv2's; every CABAC context the
I, P and B slices of progressive 4:2:0 pictures can read coded by
chip_smoke.py's exerciser clips under each of the four tables; the
tables equal to those of cv2's libavcodec; damaged CABAC slices; a seek;
the refusals of what stays undecoded, each naming its ROADMAP item; and a
Stray Scanner capture coded as the app codes it through both CLIs."""

import copy
import glob
import os
import re
import sys
from os.path import join as pjoin
from unittest import mock

import cv2
import numpy as np
import pytest

import chip_smoke
from hive_tpu.meshing.gltf import load_glb as jax_load_glb
from hive_tpu.pipeline import Pipeline as JaxPipeline
from hive_tpu_torch import native
from hive_tpu_torch.meshing.gltf import load_glb
from hive_tpu_torch.pipeline import Pipeline
from hive_tpu_torch.video import h264, h264_bits, mp4
from hive_tpu_torch.video.capture import VideoCapture
from tests.test_torch_h264 import (CORRUPT, decoder_before, pps_unit, rewrite, sps_unit,
                                   write_units)
from tests.test_torch_mpeg4 import assert_reads_as_cv2, scene_planes
from tests.test_torch_video_adaptors import VOCAB, compare_converted, make_stray, scene_frames

W, H, N = 96, 64, 10
HIGH = dict(profile=100, transform_8x8=True)


def lists(seed, sizes=(16,) * 6 + (64,) * 2):
    """Explicit scaling lists of weights 4-67, one of each size."""
    return [chip_smoke.scaling_list(size, seed + k) for k, size in enumerate(sizes)]


# name -> (write_h264_mp4 options, Exerciser options)
HIGH_CASES = {
    "cabac_i_slices": (dict(HIGH, cabac=True), dict(gop=1, t8x8=0.5)),
    "cabac_init_idc_0": (dict(HIGH, cabac=True), dict(t8x8=0.5, init_idcs=(0,))),
    "cabac_init_idc_1": (dict(HIGH, cabac=True), dict(t8x8=0.5, init_idcs=(1,))),
    "cabac_init_idc_2": (dict(HIGH, cabac=True), dict(t8x8=0.5, init_idcs=(2,))),
    "cabac_main_profile_slices_mixed": (dict(profile=77, cabac=True, num_ref_frames=3),
                                        dict(init_idcs=(0, 1, 2), mmco=0.8)),
    "cabac_constrained_intra_offsets": (dict(HIGH, cabac=True, constrained_intra=True,
                                             chroma_qp_offset=-5, second_chroma_qp_offset=3),
                                        dict(t8x8=0.5, init_idcs=(0, 2))),
    "cabac_out_of_order": (dict(HIGH, cabac=True, reorder=True), dict(gop=100, t8x8=0.5)),
    "cabac_low_qp": (dict(HIGH, cabac=True, init_qp=12), dict(qp=12, gop=4, t8x8=0.5)),
    "cabac_high_qp": (dict(HIGH, cabac=True, init_qp=46), dict(qp=46, t8x8=0.5)),
    "cavlc_8x8_low_qp": (dict(HIGH, init_qp=14), dict(qp=14, gop=4, t8x8=0.7)),
    "sps_explicit_lists": (dict(HIGH, cabac=True, scaling=dict(sps=lists(1))), dict(t8x8=0.5)),
    "sps_default_lists": (dict(HIGH, scaling=dict(sps=["default"] * 8)), dict(t8x8=0.5)),
    "sps_fall_back_a": (dict(HIGH, cabac=True, scaling=dict(
        sps=[None, None, None, None, None, None, None, None])), dict(t8x8=0.5)),
    "pps_fall_back_a": (dict(HIGH, scaling=dict(
        pps=[lists(3)[0], None, None, None, lists(4)[0], None, None, None])), dict(t8x8=0.5)),
    "pps_fall_back_b": (dict(HIGH, cabac=True, scaling=dict(
        sps=lists(5), pps=[None, "default", None, None, lists(6)[0], None, None, None])),
                        dict(t8x8=0.5)),
    "pps_lists_without_8x8": (dict(profile=100, cabac=True, scaling=dict(
        pps=lists(7)[:6] + [None, None])), dict()),
}


def write_case(path, case, count=N):
    options, planner = HIGH_CASES[case]
    planner = dict(dict(gop=5), **planner)
    return h264.write_h264_mp4(str(path), scene_planes(count, W, H, seed=len(case)),
                               h264.Exerciser(W, H, seed=len(case) + 11, **planner), **options)


@pytest.mark.parametrize("case", sorted(HIGH_CASES))
def test_high_profile_clips_read_as_cv2(tmp_path, case):
    """Each stream layout, the seeded exerciser's mix of every macroblock
    path in it (I_PCM among them), reads as cv2 reads it, every frame."""
    stats = write_case(tmp_path / "clip.mp4", case)
    assert_reads_as_cv2(tmp_path / "clip.mp4", count=N)
    options, planner = HIGH_CASES[case]
    if planner.get("t8x8"):
        assert sum(stats[f"i8x8_mode_{m}"] for m in range(9)) > 0
    if options.get("cabac"):
        assert stats["coverage"]["cabac_contexts"].sum() > 0
        assert stats["coverage"]["coeff_token"].sum() == 0


def test_intra16x16_dc_rounds_as_cv2(tmp_path):
    """Intra16x16 macroblocks below qP 30 whose scaling list's DC weight
    makes FFmpeg's x86 luma DC multiplier odd above bit 6 (57 x 13 << 6):
    cv2 rounds these DCs otherwise than 8.5.10, and the port as cv2 does."""
    mbw, mbh = 4, 3
    rng = np.random.default_rng(2)
    mbs = np.stack([h264.plan_record(h264.PLAN_I16, 26, i16_mode=int(rng.integers(0, 4)),
                                     chroma_mode=int(rng.integers(0, 4)))
                    for _ in range(mbw * mbh)])
    path = tmp_path / "dc.mp4"
    for seed in range(4):
        h264.write_h264_mp4(
            str(path), scene_planes(1, 16 * mbw, 16 * mbh, seed=seed),
            lambda index, dpb: h264.PicturePlan(h264.I_SLICE, mbs,
                                                [h264.SlicePlan(0, mbw * mbh, lf_idc=1)],
                                                idr=True),
            profile=100, scaling=dict(pps=[(57,) + (16,) * 15, None, None, None, None, None]))
        assert_reads_as_cv2(path, count=1)


@pytest.fixture(scope="module")
def chip_smoke_high_clips(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("chip_smoke_high"))
    return [chip_smoke.write_h264_exerciser(folder, index)
            for index, clip in enumerate(chip_smoke.H264_EXERCISER_CLIPS)
            if clip[2].get("profile") == 100 and clip[2].get("transform_8x8")]


def test_chip_smoke_clips_code_every_reachable_context(chip_smoke_high_clips):
    """Over chip_smoke.py's High profile exerciser clips (CABAC with
    cabac_init_idc 0, 1, 2, and CAVLC; B pictures in two), every CABAC
    context that I, P and B slices of progressive 4:2:0 pictures can read
    is coded under each of the four tables (the I slices' and each
    cabac_init_idc's), and no other; so a wrong (m, n) anywhere in those
    tables changes a digest."""
    assert len(chip_smoke_high_clips) == 6
    coded = sum(stats["coverage"]["cabac_contexts"] for _, stats in chip_smoke_high_clips)
    reachable = h264.cabac_contexts_reachable()
    assert [(t, int(c)) for t, c in zip(*np.nonzero(reachable & (coded == 0)))] == []
    assert not coded[~reachable].any()
    assert reachable.sum() == 8 + 10 + 203 + 37 + 3 * (13 + 16 + 30 + 203 + 37)


def test_chip_smoke_clips_write_each_scaling_list_path():
    """The exerciser clips' parameter sets hold explicit lists (one ending
    in a run that nextScale 0 codes), default ones, and absent ones under
    rule A (each of the eight lists) and rule B (each of the eight)."""
    explicit = default = False
    rule_a, rule_b = set(), set()
    for _, _, options, _, _ in chip_smoke.H264_EXERCISER_CLIPS:
        scaling = options.get("scaling") or {}
        for name in ("sps", "pps"):
            entries = scaling.get(name)
            if entries is None:
                continue
            for i, entry in enumerate(entries):
                explicit |= isinstance(entry, tuple)
                default |= entry == "default"
                if entry is None:
                    (rule_b if name == "pps" and "sps" in scaling else rule_a).add(i)
    assert explicit and default and rule_a == rule_b == set(range(8))


# ---------------------------------------------------------------------------
# The tables against cv2's libavcodec.
# ---------------------------------------------------------------------------

LIBAVCODEC = "libavcodec-c4204469.so.62.28.101"
# Byte offsets of FFmpeg's copies in that build: (table, offset, layout).
LIBAV_OFFSETS = dict(init_p0=15534240, init_p1=15536288, init_p2=15538336, init_i=15540384,
                     lps=15268416, last8=15269184, sig8=15533632, zigzag8=15784512,
                     default4=15546784, default8=15546656, norm8=15547840)


def libavcodec():
    found = glob.glob(pjoin(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs",
                            LIBAVCODEC))
    if not found:
        pytest.skip(f"{LIBAVCODEC} (cv2 5.0.0's FFmpeg) is not installed here")
    return np.fromfile(found[0], np.uint8)


def header_tables():
    text = ""
    for name in ("h264_tables.h", "cabac.h"):
        with open(pjoin(os.path.dirname(native.__file__), "src", name)) as f:
            text += f.read()
    out = {}
    for name, body in re.findall(r"const \w+ (\w+)(?:\[\d+\])+ = \{(.*?)\};", text, re.S):
        out[name] = np.array([int(v) for v in re.findall(r"-?\d+", body)])
    return out


def test_tables_equal_those_of_cv2s_libavcodec():
    """Every table of h264_tables.h (and the module's default lists and
    8x8 scan) equals FFmpeg's copy in the libavcodec that cv2 5.0.0 loads:
    the context initialisation tables of I slices and of each
    cabac_init_idc, rangeTabLPS and the state transitions (FFmpeg keeps
    them as a table of next states), the 8x8 blocks' significance and last
    ctxIdxInc, the 8x8 zig-zag, normAdjust8x8 and the default lists."""
    lib = libavcodec()

    def at(name, size, signed=False):
        data = lib[LIBAV_OFFSETS[name]:LIBAV_OFFSETS[name] + size]
        return data.view(np.int8).astype(int) if signed else data.astype(int)

    tables = header_tables()
    np.testing.assert_array_equal(tables["kCabacInitI"], at("init_i", 2048, True))
    np.testing.assert_array_equal(
        tables["kCabacInitP"],
        np.concatenate([at(f"init_p{k}", 2048, True) for k in range(3)]))
    lps = at("lps", 512).reshape(4, 64, 2)
    assert (lps[..., 0] == lps[..., 1]).all()
    np.testing.assert_array_equal(tables["kRangeTabLPS"], lps[..., 0].T.ravel())
    states = at("lps", 768)[512:]                  # FFmpeg's 2 * pStateIdx + valMPS
    np.testing.assert_array_equal(tables["kTransIdxMPS"], states[128::2][:64] >> 1)
    np.testing.assert_array_equal(tables["kTransIdxLPS"], states[127::-2][:64] >> 1)
    np.testing.assert_array_equal(tables["kSig8x8Inc"], at("sig8", 63))
    np.testing.assert_array_equal(tables["kLast8x8Inc"], at("last8", 63))
    np.testing.assert_array_equal(tables["kZigzag8x8"], at("zigzag8", 64))
    np.testing.assert_array_equal(h264.ZIGZAG_8X8, at("zigzag8", 64))
    np.testing.assert_array_equal(tables["kNormAdjust8x8"], at("norm8", 36))
    raster4 = at("default4", 32).reshape(2, 16)
    raster8 = at("default8", 128).reshape(2, 64)
    scan4 = raster4[:, list(h264.ZIGZAG_4X4)]
    scan8 = raster8[:, list(h264.ZIGZAG_8X8)]
    np.testing.assert_array_equal(tables["kDefault4x4"], scan4.ravel())
    np.testing.assert_array_equal(tables["kDefault8x8"], scan8.ravel())
    np.testing.assert_array_equal(h264.DEFAULT_4X4, scan4)
    np.testing.assert_array_equal(h264.DEFAULT_8X8, scan8)


# ---------------------------------------------------------------------------
# Damage, seeks, refusals, the native library.
# ---------------------------------------------------------------------------

def cabac_units(tmp_path):
    """A small written CABAC High stream: its SPS, PPS and each sample's NAL
    units."""
    path = tmp_path / "cabac_source.mp4"
    h264.write_h264_mp4(str(path), scene_planes(4, 64, 48),
                        h264.Exerciser(64, 48, 3, gop=10, t8x8=0.5),
                        **HIGH, cabac=True)
    track = mp4.read_track(str(path))
    length, sps, pps = mp4.parse_avcc(track.config)
    with open(path, "rb") as f:
        samples = []
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            samples.append(mp4.split_nal_units(f.read(int(size)), length))
    return sps[0], pps[0], samples


def test_truncated_cabac_slices_are_refused_as_corrupt(tmp_path):
    """Every sample's first CABAC slice cut after its header and a quarter,
    half and three quarters into its data: refused as corrupt, the
    arithmetic decoder reading no further than the slice's padding."""
    sps, pps, samples = cabac_units(tmp_path)
    for k, sample in enumerate(samples):
        decoder = decoder_before(sps, pps, samples, k)
        unit = sample[0]
        for cut in (len(unit) // 8, len(unit) // 4, len(unit) // 2, 3 * len(unit) // 4):
            with pytest.raises(ValueError, match=CORRUPT):
                copy.deepcopy(decoder).decode([unit[:max(cut, 2)]] + sample[1:])


def test_bit_flipped_cabac_slices_decode_or_are_refused_as_corrupt(tmp_path):
    """Single and burst bit flips in every sample's CABAC slice data: the
    picture decodes at its size or is refused as corrupt (or by name, where
    a flip lands in a header field)."""
    sps, pps, samples = cabac_units(tmp_path)
    rng = np.random.default_rng(6)
    outcomes = set()
    for k, sample in enumerate(samples):
        decoder = decoder_before(sps, pps, samples, k)
        for _ in range(30):
            unit = np.frombuffer(h264_bits.unescape(sample[0]), np.uint8).copy()
            first = int(rng.integers(40, 8 * len(unit)))
            for bit in range(first, min(first + int(rng.choice([1, 1, 9, 64])), 8 * len(unit))):
                unit[bit >> 3] ^= 0x80 >> (bit & 7)
            damaged = bytes([unit[0]]) + h264_bits.escape(unit[1:]).tobytes()
            try:
                picture = copy.deepcopy(decoder).decode([damaged] + sample[1:])
            except mp4.UnsupportedVideoError:
                outcomes.add("refused by name")
            except ValueError as e:
                assert any(s in str(e) for s in CORRUPT.split("|")), e
                outcomes.add("refused")
            else:
                assert picture.y.shape == (48, 64)
                outcomes.add("decoded")
    assert {"refused", "decoded"} <= outcomes


def test_cabac_seek_from_the_nearest_idr_picture_reads_as_cv2(tmp_path):
    """CABAC with the 8x8 transform, an IDR picture every 5: each frame
    read alone (decoded from the IDR picture before it) equals cv2's read
    loop."""
    path = tmp_path / "clip.mp4"
    h264.write_h264_mp4(str(path), scene_planes(12, 64, 48),
                        h264.Exerciser(64, 48, 4, gop=5, t8x8=0.5), **HIGH,
                        cabac=True)
    _, frames = assert_reads_as_cv2(path)
    capture = VideoCapture(str(path), device="cpu")
    for index in (0, 4, 5, 7, 11):
        np.testing.assert_array_equal(capture.frame(index).numpy(), frames[index])


def test_without_the_native_library_a_cabac_clip_raises_naming_the_build(tmp_path,
                                                                         monkeypatch):
    """No numpy decoder stands beside the native one for CABAC either."""
    path = tmp_path / "clip.mp4"
    h264.write_h264_mp4(str(path), scene_planes(2, 64, 48), h264.Exerciser(64, 48, 1), **HIGH,
                        cabac=True)
    monkeypatch.setattr(native, "get_native_lib", lambda: None)
    monkeypatch.setattr(native, "_build_error", "g++ -c h264_decode.cpp did not run")
    capture = VideoCapture(str(path), device="cpu")
    with pytest.raises(RuntimeError, match="h264_decode.cpp.*did not run"):
        capture.frame(0)


# What stays refused, each naming the ROADMAP item that will lift it:
# (slice type or SPS / PPS options, the name, the item). B slices and
# weighted prediction (9f-3) decode now: tests/test_torch_h264_bslices.py.
STILL_REFUSED = {
    "si_slices": (dict(slice_type=4), "SI slices", "9f"),
    "sp_slices": (dict(slice_type=3), "SP slices", "9f"),
    "mbaff": (dict(sps=dict(frame_mbs_only=0, mbaff=1)), "fields or MBAFF", "9f-4"),
    "fields": (dict(sps=dict(frame_mbs_only=0)), "fields or MBAFF", "9f-4"),
    "chroma_4_2_2": (dict(sps=dict(profile=122, chroma_format=2)), "chroma format 4:2:2", "9f"),
}


@pytest.mark.parametrize("case", sorted(STILL_REFUSED))
def test_still_refused_features_name_their_roadmap_item(tmp_path, case, monkeypatch):
    """Fields and MBAFF (9f-4) and the rest (9f): refused when the capture
    opens, before any slice is decoded, each naming its item."""
    change, name, item = STILL_REFUSED[case]
    sps, pps, samples = cabac_units(tmp_path)
    samples = list(samples)
    if "slice_type" in change:
        samples[1] = [rewrite(samples[1][0], sps, pps, **change)] + samples[1][1:]
    if "pps" in change:
        pps = pps_unit(**change["pps"])
    if "sps" in change:
        sps = sps_unit(**change["sps"])
    path = tmp_path / f"{case}.mp4"
    write_units(path, sps, pps, samples)
    monkeypatch.setattr(h264.H264Decoder, "_decode_slice", None)
    with pytest.raises(mp4.UnsupportedVideoError,
                       match=f"{name}.*Queue 1 item {re.escape(item)}\\)"):
        VideoCapture(str(path), device="cpu")


# ---------------------------------------------------------------------------
# A Stray Scanner capture as the app codes it, through both CLIs.
# ---------------------------------------------------------------------------

def make_high_video(path, num_frames=6, width=64, height=48, seed=5):
    """The test scene as the Stray Scanner app codes rgb.mp4: H.264 High
    profile, CABAC, the 8x8 transform, P slices (the seeded exerciser)."""
    h264.write_h264_mp4(str(path), scene_frames(num_frames, width, height),
                        h264.Exerciser(width, height, seed, gop=4, t8x8=0.6), **HIGH,
                        cabac=True)
    return str(path)


@pytest.fixture(autouse=True)
def no_weights(tmp_path, monkeypatch):
    """No segmentation weights: both packages take the motion backend."""
    monkeypatch.setenv("WEIGHTS_PATH", str(tmp_path / "no_weights"))


def test_cli_converts_and_meshes_a_cabac_stray_capture_like_hive_tpu(tmp_path):
    """A 320x240, 6-frame Stray Scanner capture whose rgb.mp4 is CABAC High
    profile with the 8x8 transform (hive_tpu reads it through cv2): both
    CLIs give equal converted folders (frames, depth, masks, metadata) and
    an equal ``bg.glb``."""
    base = make_stray(tmp_path / "stray", num_frames=6, width=320, height=240,
                      depth_hw=(48, 64), roll_deg=-90.0, writer=make_high_video)
    assert_reads_as_cv2(pjoin(base, "rgb.mp4"), count=6)
    paths = {name: str(tmp_path / name) for name in ("ours", "theirs")}

    def args(path):
        return ["--dataset_path", base, "--output_path", path, "--key_frame_threshold", "1.0",
                "--sdf_max_voxels", "200000", "--background_only", "--disable_scaling",
                "--vocab_path", VOCAB, "--webxr_path", path + "_webxr", "--log_file",
                path + ".log"]

    with mock.patch.object(sys, "argv", ["hive", *args(paths["theirs"])]):
        JaxPipeline.from_command_line().run(compress=False)
    Pipeline.from_command_line(args(paths["ours"]), device="cpu").run(compress=False)
    compare_converted(paths["ours"], paths["theirs"])
    ours = load_glb(pjoin(paths["ours"], "mesh", "bg.glb"))
    theirs = jax_load_glb(pjoin(paths["theirs"], "mesh", "bg.glb"))
    assert ours.node_names == theirs.node_names
    for name in ours.node_names:
        got, want = ours.geometry[name], theirs.geometry[name]
        assert len(want.faces) > 0
        for attribute in ("faces", "vertices", "vertex_colors"):
            np.testing.assert_array_equal(getattr(got, attribute), getattr(want, attribute))
