"""HEVC P and B slices decoded by hive_tpu_torch (``video/hevc.py``,
``native/src/hevc_decode.cpp``) bit-equal to cv2 5.0.0's frames: the VGA
inter exerciser clips of chip_smoke.py (``video.hevc.Exerciser`` with a
``GopStructure``, seeded), which together write every path of P and B
slices the writer counts (skip, each merge index and candidate kind,
AMVP with scaled and temporal predictors, bi-prediction and its 8x4 cut,
every part mode with AMP and NxN, explicit weights, modified lists, the
parallel merge level, interSplitFlag, RASL, RADL, TSA, STSA and BLA
pictures, long-term references, pictures not output and pictures dropped
by no_output_of_prior_pics_flag) and code every context P and B slices can
read under both of their CABAC tables; the x265-shaped clip of
``video.hevc.InterPlanner``; the digests by which chip_smoke.py holds the
card's host, which has no cv2; and the header syntax the inter pictures
add (reference picture sets with their used flags and inter-set
prediction, long-term entries, pred_weight_table, the lists'
modification), the RASL pictures FFmpeg drops and what that does to the
frame count and a seek, and the refusal of ROADMAP item 9c-2b. Each
clip is read by cv2 three times (its FFmpeg decodes HEVC on frame threads)
before its frames are compared."""

import numpy as np
import pytest
import torch

import chip_smoke
from hive_tpu_torch.video import hevc, mp4
from hive_tpu_torch.video.capture import VideoCapture
from hive_tpu_torch.video.h264_bits import BitReader, BitWriter
from tests.test_torch_hevc import write_units
from tests.test_torch_mpeg4 import assert_reads_as_cv2, cv2_read, scene_planes

INTER = [(i, c) for i, c in enumerate(chip_smoke.HEVC_EXERCISER_CLIPS) if "inter" in c[3]]


def read_three_times(path):
    """cv2's frames, the same over three reads."""
    reads = [cv2_read(path)[1] for _ in range(3)]
    assert all(len(r) == len(reads[0]) and all(np.array_equal(a, b) for a, b in zip(r, reads[0]))
               for r in reads[1:])
    return reads[0]


@pytest.fixture(scope="module")
def exercisers(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("hevc_inter_exercisers"))
    return {c[0]: chip_smoke.write_hevc_exerciser(folder, i) for i, c in INTER}


@pytest.mark.parametrize("name", [c[0] for _, c in INTER])
def test_inter_exerciser_clips_read_as_cv2_and_hash_to_their_digests(exercisers, name):
    """Each inter exerciser clip: cv2 reads the same frames three times, the
    port reads cv2's frames (the pictures not output left out of both), and
    the file and the frames hash to the digests chip_smoke.py holds the
    card's host to."""
    path, _ = exercisers[name]
    read_three_times(path)
    capture, frames = assert_reads_as_cv2(path)
    samples = dict((c[0], c[1]) for _, c in INTER)[name]
    assert capture.frame_count <= samples
    got = (chip_smoke.file_digest(path), chip_smoke.frames_digest(frames))
    assert got == chip_smoke.HEVC_EXERCISER_DIGESTS[name]


def test_inter_exerciser_clips_write_every_path_and_context(exercisers):
    """Over the inter exerciser clips every path of P and B slices the
    writer counts is written, every picture-level path (each NAL unit type
    of a GOP, slice types mixed in a picture, sets from the SPS and in the
    headers, overrides, modified lists, weights, each collocated list, a
    picture without TMVP or output, sub-layer 1), and every context P and B
    slices can read is coded under initType 1 and under initType 2."""
    totals, contexts = {}, np.zeros((3, hevc.NUM_CONTEXTS), np.int64)
    for _, stats in exercisers.values():
        for name, value in stats.items():
            if name != "contexts":
                totals[name] = totals.get(name, 0) + value
        contexts += stats["contexts"]
    inter = set(hevc.STAT_NAMES) - set(hevc.INTRA_STAT_NAMES)
    assert [n for n, v in totals.items() if v == 0 and (n in inter or n not in hevc.STAT_NAMES)
            and n not in ("deblocking_off_slices", "idr_w_radl")] == []
    reach = hevc.contexts_reachable()
    assert [(int(t), int(c)) for t, c in zip(*np.nonzero(reach[1:] & (contexts[1:] == 0)))] == []
    assert reach[1:].sum() == 2 * (hevc.NUM_CONTEXTS - 2)


def x265_clip(path, frames=12, width=192, height=128):
    hevc.write_hevc_mp4(str(path), scene_planes(frames, width, height),
                        hevc.InterPlanner(width, height, qp=27, slices=2, cra_every=10),
                        ctb_log2=6, max_tb_log2=5, max_depth_intra=1, max_depth_inter=1,
                        sign_hiding=True, temporal_mvp=True, weighted_pred=True,
                        num_ref_default=(3, 1), init_qp=27)


def test_x265_shaped_clip_reads_as_cv2(tmp_path):
    """The planner of real clips (x265's medium preset: CTU 64, B pyramids
    of four, three references, open GOP, weightp, TMVP, MaxNumMergeCand 3,
    SAO, sign hiding) on the moving test scene: cv2's frames three times,
    and each frame a seek gives (the RASL ones decoded from the IDR
    picture, not from their CRA picture)."""
    path = tmp_path / "x265.mp4"
    x265_clip(path)
    read_three_times(path)
    capture, frames = assert_reads_as_cv2(path, count=12)
    for index in (7, 10, 3):                       # RASL_R, CRA, a non-reference B
        np.testing.assert_array_equal(capture.frame(index).numpy(), frames[index])


def test_rasl_pictures_of_the_first_cra_are_dropped_as_cv2_drops_them(tmp_path):
    """A stream cut to start at its CRA picture: FFmpeg drops that
    picture's RASL pictures (their references are gone), so cv2 reads four
    frames fewer; the port's frame count and frames are cv2's, and a seek
    to each frame left decodes it."""
    full = tmp_path / "full.mp4"
    x265_clip(full)
    track = mp4.read_track(str(full))
    length, units = hevc.parse_hvcc(track.config)
    with open(full, "rb") as f:
        samples = []
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            samples.append(mp4.split_nal_units(f.read(int(size)), length))
    types = [hevc.nal_type(s[0]) for s in samples]
    cra = types.index(hevc.CRA_NUT)
    cut = tmp_path / "cut.mp4"
    kept = samples[cra:]
    entry = mp4.visual_entry(b"hvc1", 192, 128, mp4.box(b"hvcC", track.config))
    mp4.write_mp4(str(cut), entry, [b"".join(len(u).to_bytes(4, "big") + u for u in s)
                                    for s in kept],
                  width=192, height=128, timescale=30, durations=[1] * len(kept),
                  sync=[hevc.nal_type(s[0]) in (hevc.CRA_NUT,) for s in kept])
    rasl = sum(t in (hevc.RASL_N, hevc.RASL_R) for t in types[cra:])
    assert rasl == 4
    capture, frames = assert_reads_as_cv2(cut, count=len(kept) - rasl)
    for index in range(len(frames)):
        np.testing.assert_array_equal(capture.frame(index).numpy(), frames[index])


# ---------------------------------------------------------------------------
# The header syntax of P and B pictures.
# ---------------------------------------------------------------------------

def test_reference_picture_sets_round_trip_with_used_flags_and_prediction():
    """Short-term sets keep each delta POC with its used flag through the
    SPS (each predicted from the one before where it can be) and a slice
    header (predicted from any SPS set, or coded explicitly), and the
    prediction codes fewer bits than the explicit sets."""
    sets = [((-1, True), (-2, False), (3, True)), ((-2, True), (-3, True), (2, False)),
            ((-1, True), (1, True), (2, True)), ((-4, False), (5, True))]
    sps = hevc.parse_sps(hevc._rbsp(hevc.encode_sps(64, 48, st_rps=sets)))
    assert sps["st_rps"] == sets
    for rps in (((-2, True), (1, False)), ((-3, True), (-5, False), (7, True)), ()):
        w = BitWriter()
        hevc._write_st_ref_pic_set(w, len(sets), sets, rps)
        assert hevc._st_ref_pic_set(BitReader(w.align(True), 0), len(sets), sets, True) == rps
    predicted, explicit = BitWriter(), BitWriter()
    hevc._write_st_ref_pic_set(predicted, 1, sets[:2], sets[1])
    hevc._write_st_ref_pic_set(explicit, 1, sets[:2], sets[1], predict=False)
    assert len(predicted.align(True)) <= len(explicit.align(True))
    # inter_ref_pic_set_prediction_flag's own derivation (7-61, 7-62): the
    # first set shifted by -1 (-2, -3 dropped by use_delta_flag, 2 kept
    # unused), and deltaRps itself.
    w = BitWriter().u(1, 1).u(1, 1).ue(0)          # predicted, deltaRps -1
    for used, use in ((1, 1), (0, 0), (0, 1), (1, 1)):
        w.u(1, used)
        if not used:
            w.u(1, use)
    got = hevc._st_ref_pic_set(BitReader(w.align(True), 0), 1, sets[:1])
    assert got == ((-1, True), (-2, True), (2, False))


def test_pred_weight_table_and_list_modification_round_trip(tmp_path):
    """A B slice header's lists, their modification, mvd_l1_zero,
    cabac_init, the collocated picture, pred_weight_table and
    MaxNumMergeCand read back as written; the weights' values derive as
    8.5.3.3.4.3 says (the chroma offset from its delta), and RefPicListX
    cycles through the current pictures and takes list_entry_lX."""
    sps = hevc.parse_sps(hevc._rbsp(hevc.encode_sps(64, 48, temporal_mvp=True)))
    pps = hevc.parse_pps(hevc._rbsp(hevc.encode_pps(
        weighted_pred=True, weighted_bipred=True, lists_modification=True,
        cabac_init_present=True, num_ref_default=(2, 1), output_flag=True)))
    table = hevc.WeightTable(luma_denom=5, chroma_denom=3,
                             luma=([(7, -9), None, (-3, 4)], [None, (12, 2)]),
                             chroma=([None, ((3, -40), (-5, 60)), None],
                                     [((1, 2), (3, 4)), None]))
    sh = hevc.SliceHeader(hevc.TRAIL_N, slice_type=hevc.B_SLICE, poc_lsb=6, pic_output=False,
                          rps=((-2, True), (-4, False), (2, True)), tmvp=True, num_ref=(3, 2),
                          ref_override=True, list_entry=((1, 0, 1), None), mvd_l1_zero=True,
                          cabac_init=True, col_from_l0=False, col_ref_idx=1, weights=table,
                          max_merge=3, qp_delta=2)
    got = hevc.parse_slice_header(hevc.write_slice_header(sh, sps, pps) + b"\xAB", {0: sps},
                                  {0: pps})
    for field in ("slice_type", "poc_lsb", "pic_output", "rps", "tmvp", "num_ref",
                  "list_entry", "mvd_l1_zero", "cabac_init", "col_from_l0", "col_ref_idx",
                  "max_merge", "qp_delta"):
        assert getattr(got, field) == getattr(sh, field), field
    assert (got.weights.luma, got.weights.chroma) == (table.luma, table.chroma)
    assert got.init_type == 1 and hevc.num_pic_total_curr(got) == 2
    # LumaWeightL0[0] = 32 + 7, offset -9; ChromaOffsetL0[1][0] =
    # Clip3(-128, 127, 128 - 40 - ((128 * 11) >> 3)) = -88.
    assert table.values(0, 0) == [39, -9, 8, 0, 8, 0]
    # ChromaOffsetL0[1][1] = Clip3(-128, 127, 128 + 60 - ((128 * 3) >> 3)).
    assert table.values(0, 1) == [32, 0, 11, -88, 3, 127]
    before, after = ["b1", "b2"], ["a1"]
    assert hevc.ref_list(before, after, 5, None, 0) == ["b1", "b2", "a1", "b1", "b2"]
    assert hevc.ref_list(before, after, 2, None, 1) == ["a1", "b1"]
    assert hevc.ref_list(before, after, 3, (2, 2, 0), 0) == ["a1", "a1", "b1"]
    assert hevc.ref_list(before, after, 5, None, 1, ["lt"]) == ["a1", "b1", "b2", "lt", "a1"]


def test_long_term_entries_round_trip_with_sps_candidates_and_msb_cycles():
    """A slice header's long-term entries read back as written: two from
    the SPS's candidates (by lt_idx_sps), two coded in the header, the MSB
    cycles summed across entries as 7-52 says and restarted at the first
    header entry; NumPicTotalCurr counts the used ones."""
    raw = hevc._rbsp(hevc.encode_sps(64, 48, log2_max_poc_lsb=5,
                                     long_term=[(3, True), (9, False), (17, True)]))
    sps = hevc.parse_sps(raw)
    assert sps["lt_sps"] == [(3, True), (9, False), (17, True)]
    pps = hevc.parse_pps(hevc._rbsp(hevc.encode_pps()))
    entries = ((17, True, True, 1, 2), (9, False, True, 3, 1), (5, True, False, 0, -1),
               (30, False, True, 2, -1))
    sh = hevc.SliceHeader(hevc.TRAIL_R, slice_type=hevc.P_SLICE, poc_lsb=12,
                          rps=((-1, True),), long_term=entries, num_ref=(1, 0))
    got = hevc.parse_slice_header(hevc.write_slice_header(sh, sps, pps) + b"\xAB", {0: sps},
                                  {0: pps})
    assert got.long_term == entries
    assert hevc.num_pic_total_curr(got) == 3


def test_a_change_of_picture_size_is_refused_by_name(tmp_path):
    """A second SPS of another size, active from an IDR picture in the
    stream (hev1, parameter sets in band), is refused when the capture
    opens, naming ROADMAP item 9c-2b."""
    path = tmp_path / "sizes.mp4"
    hevc.write_hevc_mp4(str(path), scene_planes(2, 64, 48), hevc.IntraPlanner(64, 48),
                        fourcc=b"hev1", in_band=True)
    track = mp4.read_track(str(path))
    length, units = hevc.parse_hvcc(track.config)
    with open(path, "rb") as f:
        samples = []
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            samples.append(mp4.split_nal_units(f.read(int(size)), length))
    samples[1] = [hevc.encode_sps(96, 64) if hevc.nal_type(u) == hevc.SPS_NUT else u
                  for u in samples[0]]
    write_units(path, units, samples, b"hev1")
    with pytest.raises(mp4.UnsupportedVideoError,
                       match=r"a change of picture size.*Queue 1 item 9c-2b\)"):
        VideoCapture(str(path), device="cpu")


def test_ffmpeg_bumping_by_dpb_fullness_is_mirrored(tmp_path):
    """Clips of P and B pictures (two B pictures between anchors, two
    references) whose SPS gives a DPB smaller than their order needs, so
    that FFmpeg outputs pictures early from a full DPB
    (sps_max_dec_pic_buffering 2 and 3, reorder depth 1): output_order puts
    the decoded pictures in cv2's order, read three times. With 2 a picture
    goes out before a lower POC, so the capture refuses the stream naming
    ROADMAP item 9c-2b; with 3 pictures go out earlier than a roomy DPB
    lets them, still in POC order, and the capture reads cv2's frames."""
    from hive_tpu_torch.video import color

    for dpb in (2, 3):
        path = tmp_path / f"dpb{dpb}.mp4"
        hevc.write_hevc_mp4(str(path), scene_planes(9, 64, 64),
                            hevc.Exerciser(64, 64, 5, cra=0.0, max_slices=1,
                                           inter=dict(bframes=2, max_refs=2)),
                            temporal_mvp=True, dpb=dpb)
        track = mp4.read_track(str(path))
        length, units = hevc.parse_hvcc(track.config)
        decoder = hevc.HevcDecoder()
        decoder.decode(units)
        with open(path, "rb") as f:
            pictures = []
            for offset, size in zip(track.offsets, track.sizes):
                f.seek(int(offset))
                pictures.append(decoder.decode(mp4.split_nal_units(f.read(int(size)), length)))
        sps = decoder.sps[0]
        assert (sps["max_dec_pic_buffering"], sps["reorder"]) == (dpb, 1)

        def emitted(sps):
            """Each picture output as (POC, pictures decoded by then)."""
            decoded = []

            def feed():
                for picture in pictures:
                    decoded.append(picture)
                    yield picture

            return [(p.poc, len(decoded)) for p in hevc.output_order(feed(), sps)]

        order = emitted(sps)
        assert order != emitted(dict(sps, max_dec_pic_buffering=16))
        by_poc = {p.poc: p for p in pictures}
        frames = read_three_times(path)
        assert len(frames) == len(order)
        for (poc, _), want in zip(order, frames):
            p = by_poc[poc]
            got = color.planes_to_bgr([torch.from_numpy(np.ascontiguousarray(v))
                                       for v in (p.y, p.u, p.v)], sps["full_range"], sps["matrix"])
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"POC {poc}")
        pocs = [poc for poc, _ in order]
        if dpb == 2:
            assert pocs != sorted(pocs)
            with pytest.raises(mp4.UnsupportedVideoError,
                               match=r"FFmpeg's output order.*Queue 1 item 9c-2b\)"):
                VideoCapture(str(path), device="cpu")
        else:
            assert pocs == sorted(pocs)
            assert_reads_as_cv2(path, count=9)
