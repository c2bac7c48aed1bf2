"""H.264 B slices and weighted prediction in hive_tpu_torch
(``hive_tpu_torch.video.h264``, ``native/src/h264_decode.cpp``) against
cv2 5.0.0, CAVLC (CABAC: tests/test_torch_h264_bslices_cabac.py): the
writer's seeded B clips, one per path (spatial and temporal direct with and
without direct_8x8_inference, weighted_bipred_idc 0, 1 and 2, explicit P
weights, B references in a pyramid, long-term references and list 1's
modification, list 1 starting as list 0), every frame bit-equal to cv2's
and in its order; the reference lists of 8.2.4.2.3 and the slice header's
B fields and pred_weight_table written and read back; x264's layout as
chip_smoke.py's phone clip codes it; chip_smoke.py's B exerciser clips
read by cv2 to their digests on every read; damaged B slices; a seek; and
the port's video adaptor against hive_tpu's, which reads through cv2."""

import copy
import os

import numpy as np
import pytest

import chip_smoke
from hive_tpu import dataset_adaptors as jax_adaptors
from hive_tpu.options import COLMAPOptions as JaxCOLMAPOptions
from hive_tpu_torch import dataset_adaptors
from hive_tpu_torch.options import COLMAPOptions
from hive_tpu_torch.video import h264, h264_bits, mp4
from hive_tpu_torch.video.capture import VideoCapture
from tests.test_torch_h264 import CORRUPT
from tests.test_torch_mpeg4 import assert_reads_as_cv2, cv2_read, scene_planes
from tests.test_torch_video_adaptors import VOCAB, same_files, scene_frames

W, H, N = 96, 64, 12

# name -> (write_h264_mp4 options, Exerciser options, a writer count the
# case must make nonzero)
CASES = {
    "spatial_direct": (dict(profile=77), dict(bframes=2, spatial=1.0), "direct_col_zero"),
    "spatial_direct_without_8x8_inference": (
        dict(profile=77, direct_8x8_inference=False), dict(bframes=2, spatial=1.0),
        "spatial_direct_slices"),
    "temporal_direct": (dict(profile=77), dict(bframes=3, pyramid=True, spatial=0.0),
                        "direct_ref_mapped"),
    "temporal_direct_without_8x8_inference": (
        dict(profile=77, direct_8x8_inference=False), dict(bframes=3, spatial=0.0),
        "temporal_direct_slices"),
    "explicit_p_weights": (dict(profile=77, weighted_pred=True), dict(weights=1.0),
                           "p_weight_tables"),
    "explicit_b_weights": (dict(profile=77, weighted_pred=True, weighted_bipred=1),
                           dict(bframes=2, weights=1.0), "b_weight_tables"),
    "implicit_b_weights": (dict(profile=77, weighted_bipred=2), dict(bframes=3, pyramid=True),
                           "b_slices_implicit_weights"),
    "default_b_weights_pyramid": (dict(profile=77), dict(bframes=3, pyramid=True, gop=12),
                                  "b_reference_pictures"),
    "long_terms_in_list1": (dict(profile=77, num_ref_frames=4),
                            dict(bframes=3, pyramid=True, gop=12, mmco=0.8),
                            "long_term_in_list1"),
    "list1_modification": (dict(profile=77, num_ref_frames=4), dict(bframes=2, mmco=0),
                           "l1_modifications"),
    "list1_starting_as_list0": (dict(profile=77), dict(bframes=1, b_anchors=0.8),
                                "list1_swapped"),
    "several_references_by_default": (
        dict(profile=77, num_ref_default=2, num_ref_default_l1=2, num_ref_frames=4),
        dict(bframes=2, mmco=0), "ref_idx_l1_nonzero"),
}


def write_case(path, case, count=N, cases=CASES):
    options, planner, _ = cases[case]
    planner = dict(dict(gop=8), **planner)
    return h264.write_h264_mp4(str(path), scene_planes(count, W, H, seed=len(case)),
                               h264.Exerciser(W, H, seed=len(case) + 3, **planner), **options)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    folder = tmp_path_factory.mktemp("bslices")
    return {case: (folder / f"{case}.mp4", write_case(folder / f"{case}.mp4", case))
            for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_b_clips_read_as_cv2(written, case):
    """Each path's clip, the exerciser's mix of every B macroblock type in
    it, reads as cv2 reads it, every frame in cv2's order; the writer wrote
    the path the case is for."""
    path, stats = written[case]
    capture, _ = assert_reads_as_cv2(path, count=N)
    assert stats[CASES[case][2]] > 0
    if CASES[case][1].get("bframes"):
        assert stats["b_pictures"] > 0 and capture.reorder >= 1


def test_b_clips_write_every_b_path(written):
    """Over the cases: every B macroblock type and sub_mb_type, each list
    and both, intra macroblocks in B slices, each direct mode's co-located
    case (intra, predicted from list 1, colZeroFlag, a list 0 index above
    0), nonzero ref_idx_l1, and each picture path of B pictures."""
    totals = {}
    for _, stats in written.values():
        for name, value in stats.items():
            if name != "coverage":
                totals[name] = totals.get(name, 0) + value
    b_paths = [name for name in h264.STAT_NAMES if name.startswith(("b_", "pred_", "direct_"))]
    b_paths += ["intra_in_b", "ref_idx_l1_nonzero", "b_pictures", "b_reference_pictures",
                "spatial_direct_slices", "temporal_direct_slices", "p_weight_tables",
                "b_weight_tables", "b_slices_default_weights", "b_slices_explicit_weights",
                "b_slices_implicit_weights", "l1_modifications", "long_term_in_list1",
                "list1_swapped"]
    assert [name for name in b_paths if not totals[name]] == []


def ref(id_, frame_num, poc, long_term=None):
    return h264._Ref(id_, frame_num, None, long_term=long_term, poc=poc)


def test_reference_lists_follow_8_2_4_2_3():
    """B lists: list 0 the short-term pictures before the picture by
    descending POC, then those after by ascending POC, then long-term ones
    by LongTermPicNum; list 1 the other way round; where list 1 equals list
    0 its first two entries swap; each list cut to its count and modified
    by its own commands."""
    decoder = h264.H264Decoder(pixels=False)
    decoder.refs = [ref(1, 0, 0), ref(2, 1, 8), ref(3, 2, 4), ref(4, 3, 12, long_term=1),
                    ref(5, 4, 16), ref(6, 5, 2, long_term=0)]
    ids = [[r.id for r in entries] for entries in decoder.initial_lists(h264.B_SLICE, 6, 6, 256)]
    assert ids == [[3, 1, 2, 5, 6, 4], [2, 5, 3, 1, 6, 4]]
    ids = [[r.id for r in entries] for entries in decoder.initial_lists(h264.B_SLICE, 6, 20, 256)]
    assert ids == [[5, 2, 3, 1, 6, 4], [2, 5, 3, 1, 6, 4]]
    sps = dict(log2_max_frame_num=8)
    pps = dict(num_ref_idx_default=2, num_ref_idx_default_l1=3)
    sh = h264.SliceHeader(h264.NAL_SLICE, 0, slice_type=h264.B_SLICE, frame_num=6,
                          modifications=[(2, 1)], modifications_l1=[(0, 3), (1, 1)])
    l0, l1 = decoder.ref_lists(sh, sps, pps, 6)
    assert [r.id for r in l0] == [4, 3]
    assert [r.id for r in l1] == [3, 5, 2]


def test_b_slice_headers_round_trip():
    """A B slice header with both lists' counts and commands, spatial
    direct and a pred_weight_table of both lists is read back as written;
    the P slice's table too."""
    sps = h264.parse_sps(h264_bits.unescape(h264.encode_sps(64, 48, profile=77)))
    pps = h264.parse_pps(h264_bits.unescape(h264.encode_pps(weighted_pred=True,
                                                            weighted_bipred=1)))
    weights = h264.PredWeights(3, 5, [[((9, -4), None), (None, ((30, 2), (33, -1)))],
                                      [(None, None), ((6, 7), ((32, 0), (31, 12))), ((8, 0), None)]])
    for slice_type, l1 in ((h264.B_SLICE, 3), (h264.P_SLICE, None)):
        sh = h264.SliceHeader(h264.NAL_SLICE, 2, slice_type=slice_type, frame_num=5, poc_lsb=12,
                              direct_spatial=int(slice_type == h264.B_SLICE),
                              num_ref_override=2, num_ref_override_l1=l1,
                              modifications=[(0, 1), (2, 0)],
                              modifications_l1=[(1, 2)] if l1 else [], weights=weights,
                              qp_delta=-3)
        bits = h264.write_slice_header(sh, sps, pps).bits
        rbsp = np.packbits(np.array([0, 1, 0, 0, 0, 0, 0, 1] + bits + [1], np.uint8)).tobytes()
        got = h264.parse_slice_header(rbsp, {0: sps}, {0: pps})
        assert (got.slice_type, got.direct_spatial, got.num_ref(pps), got.modifications,
                got.modifications_l1, got.qp_delta) == (sh.slice_type, sh.direct_spatial, 2,
                                                        sh.modifications, sh.modifications_l1,
                                                        -3)
        want = copy.deepcopy(weights)
        if l1 is None:
            want.lists[1] = []
        assert got.weights == want
        np.testing.assert_array_equal(got.weights.table()[0, :2, 0], [9, 8])


def test_x264_layout_reads_as_cv2(tmp_path):
    """x264's layout at a small size, as chip_smoke.py's phone clip codes it
    (MotionPlanner with B pictures: a pyramid of three, B_Bi_16x16 to two
    references of each list and B_Direct_16x16, spatial direct, implicit B
    and explicit P weights, CABAC and the 8x8 transform): reads as cv2 reads
    it, with max_num_reorder_frames 2 and its pictures coded I, P, B, b."""
    frames = scene_planes(14, 64, 48)

    def motion(index, ref_index):
        return np.full((3, 4, 2), (6 * (index - ref_index), -3 * (index - ref_index)))

    path = tmp_path / "x264.mp4"
    stats = h264.write_h264_mp4(
        str(path), frames,
        h264.MotionPlanner(64, 48, motion, gop=12, refs=4, t8x8=True, bframes=3, pyramid=True,
                           p_weights=True),
        profile=100, cabac=True, transform_8x8=True, weighted_pred=True, weighted_bipred=2)
    capture, _ = assert_reads_as_cv2(path, count=14)
    assert capture.reorder == 2
    assert stats["b_direct_16x16"] and stats["pred_bi"] and stats["b_reference_pictures"]
    assert stats["b_slices_implicit_weights"] and stats["p_weight_tables"]


@pytest.mark.parametrize("index", [k for k, clip in enumerate(chip_smoke.H264_EXERCISER_CLIPS)
                                   if clip[0].startswith("b_")])
def test_chip_smoke_b_clips_read_to_their_digest_on_every_read(tmp_path, index):
    """chip_smoke.py's B exerciser clips: cv2 reads each three times, each
    time to the frames of the digest the script pins (frame threads do not
    move a B picture's pixels)."""
    path, _ = chip_smoke.write_h264_exerciser(str(tmp_path), index)
    name = chip_smoke.H264_EXERCISER_CLIPS[index][0]
    digests = {chip_smoke.frames_digest(cv2_read(path)[1]) for _ in range(3)}
    assert digests == {chip_smoke.H264_EXERCISER_DIGESTS[name][1]}


def b_units(tmp_path):
    path = tmp_path / "b_source.mp4"
    h264.write_h264_mp4(str(path), scene_planes(6, 64, 48), h264.Exerciser(64, 48, 3, bframes=2),
                        profile=77, weighted_bipred=1)
    track = mp4.read_track(str(path))
    length, sps, pps = mp4.parse_avcc(track.config)
    with open(path, "rb") as f:
        samples = []
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            samples.append(mp4.split_nal_units(f.read(int(size)), length))
    return sps[0], pps[0], samples


def test_damaged_b_slices_decode_or_are_refused_as_corrupt(tmp_path):
    """Each B picture's first slice cut short, and bit flips in it: the
    picture is refused as corrupt, or decodes at its size."""
    sps, pps, samples = b_units(tmp_path)
    rng = np.random.default_rng(8)
    decoder = h264.H264Decoder()
    decoder.decode([sps, pps])
    outcomes = set()
    for sample in samples:
        if decoder.headers([sample[0]])[0][1].slice_type == h264.B_SLICE:
            unit = sample[0]
            for cut in (len(unit) // 4, len(unit) // 2, 3 * len(unit) // 4):
                with pytest.raises(ValueError, match=CORRUPT):
                    copy.deepcopy(decoder).decode([unit[:max(cut, 2)]] + sample[1:])
            for _ in range(20):
                data = np.frombuffer(h264_bits.unescape(unit), np.uint8).copy()
                bit = int(rng.integers(40, 8 * len(data)))
                data[bit >> 3] ^= 0x80 >> (bit & 7)
                damaged = bytes([data[0]]) + h264_bits.escape(data[1:]).tobytes()
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
        decoder.decode(sample)
    assert {"refused", "decoded"} <= outcomes


def test_b_clip_frames_read_alone_as_cv2(tmp_path):
    """With B pictures coded after the anchors they predict from: each
    frame read alone (decoded from the IDR picture before it, put in display
    order) equals cv2's read loop."""
    path = tmp_path / "clip.mp4"
    h264.write_h264_mp4(str(path), scene_planes(14, 64, 48),
                        h264.Exerciser(64, 48, 4, gop=7, bframes=2, pyramid=True), profile=77)
    _, frames = assert_reads_as_cv2(path, count=14)
    capture = VideoCapture(str(path), device="cpu")
    for index in (0, 1, 2, 6, 7, 9, 13):
        np.testing.assert_array_equal(capture.frame(index).numpy(), frames[index])


def test_video_adaptor_copies_a_b_clip_like_hive_tpu(tmp_path):
    """A CAVLC clip with B pictures (a pyramid, explicit weights), which
    hive_tpu's VideoAdaptor reads through cv2: the port's adaptor gives the
    same sizes, frames and JPEG bytes from copy_frames."""
    video = str(tmp_path / "clip.mp4")
    h264.write_h264_mp4(video, scene_frames(8, 64, 48),
                        h264.Exerciser(64, 48, 6, gop=8, bframes=3, pyramid=True, weights=0.8),
                        profile=77, weighted_pred=True, weighted_bipred=1)
    ours = dataset_adaptors.VideoAdaptor(video, str(tmp_path / "ours"),
                                         colmap_options=COLMAPOptions(vocab_path=VOCAB),
                                         device="cpu")
    theirs = jax_adaptors.VideoAdaptor(video, str(tmp_path / "theirs"),
                                       colmap_options=JaxCOLMAPOptions(vocab_path=VOCAB))
    assert (ours.target_width, ours.target_height, ours.num_frames, ours.fps) == \
        (theirs.target_width, theirs.target_height, theirs.num_frames, theirs.fps) == \
        (64, 48, 8, 30.0)
    for index in range(8):
        np.testing.assert_array_equal(ours.get_frame(index), theirs.get_frame(index))
    for adaptor, name in ((ours, "ours_rgb"), (theirs, "theirs_rgb")):
        os.makedirs(tmp_path / name)
        adaptor.copy_frames(str(tmp_path / name), file_extension="jpg")
    same_files(str(tmp_path / "ours_rgb"), str(tmp_path / "theirs_rgb"))
