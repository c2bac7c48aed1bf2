"""H.264 I, P and B video in hive_tpu_torch (``hive_tpu_torch.video.h264``,
``native/src/h264_decode.cpp``) against cv2 5.0.0, whose bundled FFmpeg
decodes it: the writer's files, one per stream layout (Baseline, Main and
High profiles, POC types 0 and 2, pictures out of order with ``ctts`` and
edit lists, constrained intra prediction, chroma QP offsets, one to four
reference frames, long-term references and every memory management
control operation, ``frame_num`` wrapping, cropping; CAVLC, and CABAC and
the 8x8 transform beside them; B pictures with each weighted prediction),
each with the seeded exerciser's mix of
every macroblock path; single CAVLC codewords read back from cv2 (one
probe macroblock each, for the table entries real residuals seldom
reach); each feature the reader refuses by name before any decode, and
those it no longer refuses read as cv2 reads them; damaged samples; a
seek; and the digests by which chip_smoke.py holds the card's host, which
has no cv2, to cv2's frames. CABAC, the 8x8 transform and scaling
matrices in depth: tests/test_torch_h264_cabac.py; B slices and weighted
prediction: tests/test_torch_h264_bslices.py.
Every comparison is exact, to the bit: the properties, the frame count and every frame
``VideoCapture(device="cpu")`` returns equal what ``cv2.VideoCapture``
returns (H.264 decoding is exact by specification)."""

import copy

import numpy as np
import pytest

import chip_smoke
from hive_tpu_torch import native
from hive_tpu_torch.video import h264, h264_bits, mp4
from hive_tpu_torch.video.capture import VideoCapture
from tests.test_torch_mpeg4 import assert_reads_as_cv2, scene_planes

W, H, N = 96, 64, 16

# name -> (write_h264_mp4 options, Exerciser options, frames, size)
CASES = {
    "baseline": (dict(), dict(), N, (W, H)),
    "main_profile_one_reference": (dict(profile=77, num_ref_frames=1), dict(mmco=0), N,
                                   (W, H)),
    "high_profile_second_chroma_offset": (dict(profile=100, chroma_qp_offset=-4,
                                               second_chroma_qp_offset=5), dict(qp=32), N, (W, H)),
    "constrained_intra": (dict(constrained_intra=True, chroma_qp_offset=3), dict(), N, (W, H)),
    "poc_type_2": (dict(poc_type=2), dict(), N, (W, H)),
    "out_of_order": (dict(reorder=True), dict(gop=100), N, (W, H)),
    "out_of_order_edits": (dict(reorder=True, edits=[(4, 3), (5, 9)]), dict(gop=100), N, (W, H)),
    "mmco_reset_in_order": (dict(restriction=0, num_ref_frames=3), dict(reset=True), N, (W, H)),
    "frame_num_wrap": (dict(log2_max_frame_num=4, num_ref_default=2), dict(gop=40), 24, (W, H)),
    "low_qp": (dict(init_qp=14), dict(qp=14, gop=5), 8, (W, H)),
    "high_qp": (dict(init_qp=44), dict(qp=44), 8, (W, H)),
    "cropped": (dict(full_range=True, matrix=1), dict(), 8, (102, 58)),
    "cavlc_transform_8x8": (dict(profile=100, transform_8x8=True),
                            dict(t8x8=0.6), N, (W, H)),
    "cabac_transform_8x8": (dict(profile=100, cabac=True, transform_8x8=True),
                            dict(t8x8=0.6, init_idcs=(0, 1, 2)), N, (W, H)),
    "b_pyramid_default_weights": (dict(profile=77), dict(bframes=3, pyramid=True, gop=12), N,
                                  (W, H)),
    "b_explicit_weights": (dict(profile=77, weighted_pred=True, weighted_bipred=1),
                           dict(bframes=2, weights=0.8, mmco=0.6, b_anchors=0.5), N, (W, H)),
    "b_cabac_implicit_weights": (dict(profile=100, cabac=True, transform_8x8=True,
                                      weighted_bipred=2, direct_8x8_inference=False),
                                 dict(bframes=2, pyramid=True, t8x8=0.5, init_idcs=(0, 1, 2)),
                                 N, (W, H)),
}


def write_case(path, case):
    options, planner_options, count, (width, height) = CASES[case]
    frames = scene_planes(count, width, height, seed=len(case))
    planner = h264.Exerciser(width, height, seed=len(case) * 7 + 1, **planner_options)
    return h264.write_h264_mp4(str(path), frames, planner, **options)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    folder = tmp_path_factory.mktemp("h264")
    return {case: (folder / f"{case}.mp4", write_case(folder / f"{case}.mp4", case))
            for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_writer_files_read_as_cv2_reads_them(written, case):
    path, stats = written[case]
    capture, frames = assert_reads_as_cv2(path)
    edits = CASES[case][0].get("edits")
    assert len(frames) == (sum(d for d, _ in edits) if edits else CASES[case][2])
    assert stats["pictures"] == CASES[case][2]


def test_writer_files_write_every_path(written):
    """Over the cases, the writer wrote each macroblock path (modes,
    partitions, sub-partitions, skips, intra in P and B slices, QP deltas,
    vectors past the picture, nonzero ref_idx, long level codes, every B
    type and sub-type, each direct mode's co-located cases) and each
    picture path (slices, deblocking controls, reference counts, list
    modifications, long-term references, MMCO 1-6, non-reference
    pictures, B references, each weighted prediction); and every chroma DC
    codeword."""
    totals = {}
    for case, (_, stats) in written.items():
        for name, value in stats.items():
            if name != "coverage":
                totals[name] = totals.get(name, 0) + value
    assert [name for name, value in totals.items() if value == 0] == []
    token = sum(stats["coverage"]["coeff_token"][4] for _, stats in written.values())
    assert all(token[4 * tc + t1] for tc in range(5) for t1 in range(min(tc, 3) + 1))
    zeros = sum(stats["coverage"]["chroma_dc_total_zeros"] for _, stats in written.values())
    assert all(zeros[tc - 1, z] for tc in range(1, 4) for z in range(5 - tc))


@pytest.fixture(scope="module")
def chip_smoke_exercisers(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("chip_smoke_exercisers"))
    return [chip_smoke.write_h264_exerciser(folder, index)
            for index in range(len(chip_smoke.H264_EXERCISER_CLIPS))]


@pytest.mark.parametrize("index", range(len(chip_smoke.H264_EXERCISER_CLIPS)))
def test_chip_smoke_exerciser_clips_hash_to_their_digests(chip_smoke_exercisers, index):
    """chip_smoke.py's VGA exerciser clips, written here: each file has
    the digest the script holds the card's host's writer to, cv2 reads the
    frames of the digest it holds the card's reads to, and the port reads
    cv2's frames."""
    path, _ = chip_smoke_exercisers[index]
    name, count = chip_smoke.H264_EXERCISER_CLIPS[index][:2]
    _, frames = assert_reads_as_cv2(path, count=count)
    got = (chip_smoke.file_digest(path), chip_smoke.frames_digest(frames))
    assert got == chip_smoke.H264_EXERCISER_DIGESTS[name]


def test_chip_smoke_exerciser_clips_write_every_path(chip_smoke_exercisers):
    """Over chip_smoke.py's exerciser clips, every path the writer counts
    is written (the script checks the same on the card's host)."""
    totals = {}
    for _, stats in chip_smoke_exercisers:
        for name, value in stats.items():
            if name != "coverage":
                totals[name] = totals.get(name, 0) + value
    assert [name for name, value in totals.items() if value == 0] == []


def valid_entries():
    """Every luma coeff_token (nC class, TotalCoeff, TrailingOnes),
    total_zeros (TotalCoeff, total_zeros) and run_before (zerosLeft,
    run_before) a 4x4 block can need."""
    tokens = [(t, tc, t1) for t in range(4) for tc in range(17) for t1 in range(min(tc, 3) + 1)]
    zeros = [(tc, z) for tc in range(1, 16) for z in range(17 - tc)]
    runs = [(z, r) for z in range(1, 15) for r in range(z + 1) if z <= 6 or z >= r]
    return tokens, zeros, runs


def probe_block(total, ones, positions=None):
    """Scan-order levels: ``total`` coefficients (at ``positions``, or the
    first ones) whose last ``ones`` are +-1, the one before them (if any)
    +-2 when fewer than three."""
    levels = np.zeros(16, np.int32)
    positions = list(range(total)) if positions is None else positions
    for k, pos in enumerate(reversed(positions)):
        sign = 1 if k % 2 == 0 else -1
        levels[pos] = sign * (1 if k < ones else 2 + k % 2)
    return levels


def test_vlc_codewords_read_back_from_cv2(tmp_path):
    """One probe macroblock for each codeword a 4x4 luma block can carry,
    each macroblock its own slice (no neighbours), its levels given: block
    0 sets nC for block 1 (from its TotalCoeff), block 1 carries the
    coeff_token, blocks 2 and 3 a total_zeros and a run_before. cv2 decodes
    the picture as the port does, and the encoder's counts show each
    codeword written."""
    tokens, zeros, runs = valid_entries()
    count = max(len(tokens), len(zeros), len(runs))
    mbw, mbh = 16, -(-count // 16)
    levels = np.zeros((mbw * mbh, 16, 16), np.int32)
    setup = {0: 0, 1: 2, 2: 5, 3: 9}
    for k in range(count):
        t, tc, t1 = tokens[k % len(tokens)]
        levels[k, 0] = probe_block(setup[t], 0)
        levels[k, 1] = probe_block(tc, t1)
        tc, z = zeros[k % len(zeros)]
        levels[k, 2] = probe_block(tc, 0, list(range(tc - 1)) + [tc - 1 + z])
        z, r = runs[k % len(runs)]
        levels[k, 3] = probe_block(2, 0, [z - r, z + 1])
    mbs = np.stack([h264.plan_record(h264.PLAN_I4_LEVELS, 30) for _ in range(mbw * mbh)])
    slices = [h264.SlicePlan(a, 1) for a in range(mbw * mbh)]
    frames = scene_planes(1, 16 * mbw, 16 * mbh)
    stats = h264.write_h264_mp4(
        str(tmp_path / "probe.mp4"), frames,
        lambda index, dpb: h264.PicturePlan(h264.I_SLICE, mbs, slices, idr=True, levels=levels))
    cover = stats["coverage"]
    assert [e for e in tokens if not cover["coeff_token"][e[0], 4 * e[1] + e[2]]] == []
    assert [e for e in zeros if not cover["total_zeros"][e[0] - 1, e[1]]] == []
    assert [e for e in runs if not cover["run_before"][min(e[0], 7) - 1, e[1]]] == []
    assert_reads_as_cv2(tmp_path / "probe.mp4", count=1)


@pytest.mark.parametrize("first,later", [(h264.PLAN_I4, None), (h264.PLAN_I16, None),
                                         (h264.PLAN_PCM, h264.PLAN_I4),
                                         (h264.PLAN_PCM, h264.PLAN_I16)])
def test_single_macroblock_types_read_as_cv2(tmp_path, first, later):
    """Pictures made of one intra macroblock type (or I_PCM first, then
    another), every 16x16 and 4x4 mode asked for: what the reader of the
    I_PCM subset refused now decodes as cv2 decodes it."""
    mbw, mbh = 4, 3
    rng = np.random.default_rng(first)
    mbs = np.stack([h264.plan_record(later if a and later is not None else first, 26,
                                     i16_mode=a % 4, chroma_mode=a % 4,
                                     i4_modes=rng.integers(0, 9, 16)) for a in range(mbw * mbh)])
    path = tmp_path / "clip.mp4"
    stats = h264.write_h264_mp4(
        str(path), scene_planes(2, 16 * mbw, 16 * mbh),
        lambda index, dpb: h264.PicturePlan(h264.I_SLICE, mbs, [h264.SlicePlan(0, mbw * mbh)],
                                            idr=index == 0))
    assert_reads_as_cv2(path, count=2)
    kinds = {h264.PLAN_I4: "i4x4_mode_", h264.PLAN_I16: "i16x16_mode_"}
    for kind in (first, later):
        if kind in kinds:
            assert all(stats[f"{kinds[kind]}{m}"] for m in range(9 if kind == h264.PLAN_I4
                                                                 else 4))
    assert stats["i_pcm"] == (2 if first == h264.PLAN_PCM else 0)


def test_motion_planner_clip_reads_as_cv2(tmp_path):
    """The rendered-clip planner (as chip_smoke.py's phone clip): a slice a
    row, four references, vectors of a motion field."""
    frames = scene_planes(6, 64, 48)

    def motion(index, ref_index):
        return np.full((3, 4, 2), (6 * (index - ref_index), -3 * (index - ref_index)))

    path = tmp_path / "clip.mp4"
    stats = h264.write_h264_mp4(str(path), frames,
                                h264.MotionPlanner(64, 48, motion, gop=4, refs=3))
    assert stats["ref_idx_nonzero"] > 0 and stats["slices"] == 6 * 3
    assert_reads_as_cv2(path, count=6)


# ---------------------------------------------------------------------------
# Refusals, by name, before any decode.
# ---------------------------------------------------------------------------

def sps_unit(*, profile=66, chroma_format=1, bit_depth=0, bypass=0, scaling=0, poc_type=0,
             frame_mbs_only=1, mbaff=0):
    w = h264_bits.BitWriter().u(8, profile).u(8, 0).u(8, 51).ue(0)
    if profile in h264.HIGH_PROFILES:
        w.ue(chroma_format).ue(bit_depth).ue(bit_depth).u(1, bypass).u(1, scaling)
        if scaling:
            w.u(8, 0)
    w.ue(4).ue(poc_type)
    if poc_type == 0:
        w.ue(12)
    elif poc_type == 1:
        w.u(1, 1).se(0).se(0).ue(0)
    w.ue(1).u(1, 0).ue(3).ue(2 if frame_mbs_only else 1).u(1, frame_mbs_only)
    if not frame_mbs_only:
        w.u(1, mbaff)
    w.u(1, 1).u(1, 0).u(1, 0)
    return h264_bits.nal_unit(3, h264_bits.NAL_SPS, np.frombuffer(w.align(True), np.uint8))


def pps_unit(*, cabac=0, groups=0, weighted=0, redundant=0, t8x8=None, scaling=0):
    w = h264_bits.BitWriter().ue(0).ue(0).u(1, cabac).u(1, 0).ue(groups)
    if groups:
        w.ue(0).ue(0).ue(0)
    w.ue(0).ue(0).u(1, weighted).u(2, 0).se(0).se(0).se(0).u(1, 1).u(1, 0).u(1, redundant)
    if t8x8 is not None:
        w.u(1, t8x8).u(1, scaling)
        if scaling:
            w.u(6, 0)
        w.se(0)
    return h264_bits.nal_unit(3, h264_bits.NAL_PPS, np.frombuffer(w.align(True), np.uint8))


def stream_units(tmp_path, **options):
    """A small written stream: its SPS, PPS and each sample's NAL units."""
    path = tmp_path / "source.mp4"
    h264.write_h264_mp4(str(path), scene_planes(4, 64, 48),
                        h264.Exerciser(64, 48, 3, gop=10), **options)
    track = mp4.read_track(str(path))
    length, sps, pps = mp4.parse_avcc(track.config)
    with open(path, "rb") as f:
        samples = []
        for offset, size in zip(track.offsets, track.sizes):
            f.seek(int(offset))
            samples.append(mp4.split_nal_units(f.read(int(size)), length))
    return sps[0], pps[0], samples


def rewrite(unit, sps, pps, **changes):
    """A slice NAL unit with header fields changed, its data kept."""
    rbsp = h264_bits.unescape(unit)
    sps_fields, pps_fields = h264.parse_sps(h264_bits.unescape(sps)), \
        h264.parse_pps(h264_bits.unescape(pps))
    sh = h264.parse_slice_header(rbsp, {0: sps_fields}, {0: pps_fields})
    bits = np.unpackbits(np.frombuffer(rbsp[1:], np.uint8))[sh.bit_pos - 8:].tolist()
    for name, value in changes.items():
        setattr(sh, name, value)
    header = h264.write_slice_header(sh, sps_fields, pps_fields).bits
    body = header + bits
    while body[-1] == 0:
        body.pop()
    body.extend([0] * (-len(body) % 8))
    return bytes([unit[0]]) + h264_bits.escape(np.packbits(np.array(body, np.uint8))).tobytes()


def write_units(path, sps, pps, samples, width=64, height=48):
    mp4.write_mp4(str(path), mp4.avc1_entry(width, height, sps, pps),
                  [b"".join(len(u).to_bytes(4, "big") + u for u in s) for s in samples],
                  width=width, height=height, timescale=30, durations=[1] * len(samples),
                  sync=[i == 0 for i in range(len(samples))])


PARAMETER_SET_REFUSALS = {
    "slice_groups": (None, dict(groups=1), r"slice groups \(FMO"),
    "redundant_pictures": (None, dict(redundant=1), "redundant pictures"),
    "chroma_4_2_2": (dict(profile=122, chroma_format=2), None, "chroma format 4:2:2"),
    "monochrome": (dict(profile=100, chroma_format=0), None, "chroma format 4:0:0"),
    "10_bit": (dict(profile=110, bit_depth=2), None, "10-bit samples"),
    "transform_bypass": (dict(profile=244, bypass=1), None, "transform bypass"),
    "poc_type_1": (dict(poc_type=1), None, "pic_order_cnt_type 1"),
    "fields": (dict(frame_mbs_only=0), None, r"fields or MBAFF"),
    "mbaff": (dict(frame_mbs_only=0, mbaff=1), None, r"fields or MBAFF"),
}


@pytest.mark.parametrize("case", sorted(PARAMETER_SET_REFUSALS))
def test_parameter_set_features_are_refused_by_name(tmp_path, case, monkeypatch):
    """Each refused feature of the SPS or PPS: refused when the capture
    opens, naming it and ROADMAP Queue 1 item 9f (9f-4 for fields and
    MBAFF), no slice decoded."""
    sps_options, pps_options, name = PARAMETER_SET_REFUSALS[case]
    sps, pps, samples = stream_units(tmp_path)
    if sps_options is not None:
        sps = sps_unit(**sps_options)
    if pps_options is not None:
        pps = pps_unit(**pps_options)
    path = tmp_path / f"{case}.mp4"
    write_units(path, sps, pps, samples)
    monkeypatch.setattr(h264.H264Decoder, "_decode_slice", None)
    with pytest.raises(mp4.UnsupportedVideoError, match=f"{name}.*Queue 1 item 9f"):
        VideoCapture(str(path), device="cpu")


# What the reader refused by name until it decoded CABAC, the 8x8 transform,
# scaling matrices and weighted prediction: each parameter set feature's
# stream (write_h264_mp4 options, Exerciser options) now reads as cv2 reads
# it.
PARAMETER_SET_FEATURES = {
    "cabac": (dict(profile=77, cabac=True), dict(init_idcs=(0, 1, 2))),
    "transform_8x8": (dict(profile=100, transform_8x8=True), dict(t8x8=0.6)),
    "pps_scaling_matrices": (dict(profile=100, transform_8x8=True, scaling=dict(
        pps=[tuple(range(8, 24)), None, "default", None, None, tuple(range(40, 24, -1)),
             tuple(range(10, 74)), None])), dict(t8x8=0.6)),
    "sps_scaling_matrices": (dict(profile=100, scaling=dict(
        sps=["default", tuple(range(20, 36)), None, tuple(range(30, 14, -1)), None, None, None,
             None])), dict()),
    "weighted_prediction": (dict(profile=77, weighted_pred=True, weighted_bipred=1),
                            dict(weights=1.0, bframes=1)),
}


@pytest.mark.parametrize("case", sorted(PARAMETER_SET_FEATURES))
def test_parameter_set_features_once_refused_read_as_cv2(tmp_path, case):
    """CABAC, the 8x8 transform, PPS and SPS scaling matrices and weighted
    prediction, which the reader refused by name before it decoded them: a
    stream of each reads as cv2 reads it, and its parameter sets say so."""
    options, planner = PARAMETER_SET_FEATURES[case]
    path = tmp_path / f"{case}.mp4"
    h264.write_h264_mp4(str(path), scene_planes(8, 64, 48),
                        h264.Exerciser(64, 48, 3, gop=5, **planner), **options)
    capture, _ = assert_reads_as_cv2(path, count=8)
    sps = h264.parse_sps(h264_bits.unescape(capture.sps_units[0]))
    pps = h264.parse_pps(h264_bits.unescape(capture.pps_units[0]))
    assert {"cabac": pps["cabac"], "transform_8x8": pps["transform_8x8"],
            "pps_scaling_matrices": pps["scaling"] is not None,
            "sps_scaling_matrices": sps["scaling"] is not None,
            "weighted_prediction": pps["weighted_pred"] and pps["weighted_bipred"] == 1}[case]


def test_stream_features_are_refused_by_name(tmp_path, monkeypatch):
    """SP and SI slices, a field SPS (what refused B slices here until the
    reader decoded them), data partitioning and extension NAL units, a
    frame_num gap, POCs out of order without a reorder depth, and a change
    of size, each in a later sample: refused when the capture opens (every
    sample's headers are read first), naming it and item 9f (9f-4 for
    fields)."""
    sps, pps, samples = stream_units(tmp_path, restriction=None)
    p = next(k for k, s in enumerate(samples) if h264.parse_slice_header(
        h264_bits.unescape(s[0]), {0: h264.parse_sps(h264_bits.unescape(sps))},
        {0: h264.parse_pps(h264_bits.unescape(pps))}).slice_type == h264.P_SLICE)
    monkeypatch.setattr(h264.H264Decoder, "_decode_slice", None)

    def refused(name, changed, case):
        path = tmp_path / f"{case}.mp4"
        write_units(path, sps, pps, changed)
        with pytest.raises(mp4.UnsupportedVideoError, match=f"{name}.*Queue 1 item 9f"):
            VideoCapture(str(path), device="cpu")

    for slice_type, name in ((3, "SP slices"), (4, "SI slices")):
        changed = list(samples)
        changed[p] = [rewrite(changed[p][0], sps, pps, slice_type=slice_type)] + changed[p][1:]
        refused(name, changed, name.split()[0])
    changed = list(samples)
    changed[p] = [sps_unit(frame_mbs_only=0)] + changed[p]
    refused("fields or MBAFF", changed, "fields")
    for nal_type, name in ((2, "data partitioning"), (20, "multiview extensions")):
        changed = list(samples)
        changed[2] = [bytes([0x60 | nal_type, 0x80])] + changed[2]
        refused(name, changed, f"nal_{nal_type}")
    changed = list(samples)
    last = len(changed) - 1
    sh = h264.parse_slice_header(h264_bits.unescape(changed[last][0]),
                                 {0: h264.parse_sps(h264_bits.unescape(sps))},
                                 {0: h264.parse_pps(h264_bits.unescape(pps))})
    changed[last] = [rewrite(u, sps, pps, frame_num=(sh.frame_num + 2) % 256)
                     for u in changed[last]]
    refused("a gap in frame_num", changed, "gap")
    changed = list(samples)
    changed[1] = [rewrite(u, sps, pps, poc_lsb=100) for u in changed[1]]
    refused("POCs the stream's reorder depth .no bitstream_restriction", changed, "poc")
    changed = list(samples)
    changed[2] = [h264.encode_sps(96, 48)] + changed[2]
    refused("a change of picture size", changed, "size")


def test_cabac_clip_reads_as_cv2(tmp_path):
    """A CABAC clip (what an iPhone writes; refused until the reader decoded
    CABAC), Main profile with P slices: read as cv2 reads it."""
    path = tmp_path / "cabac.mp4"
    h264.write_h264_mp4(str(path), scene_planes(6, 64, 48),
                        h264.Exerciser(64, 48, 3, gop=10), profile=77,
                        cabac=True)
    capture, _ = assert_reads_as_cv2(path, count=6)
    assert h264.parse_pps(h264_bits.unescape(capture.pps_units[0]))["cabac"] == 1


# ---------------------------------------------------------------------------
# Damage, seeks, the native library.
# ---------------------------------------------------------------------------

def decoder_before(sps, pps, samples, k):
    decoder = h264.H264Decoder()
    decoder.decode([sps, pps])
    for sample in samples[:k]:
        decoder.decode(sample)
    return decoder


CORRUPT = "corrupt H.264|past the end of its NAL unit"


def test_truncated_samples_are_refused_as_corrupt(tmp_path):
    """Every sample's first slice cut after its header, and a quarter, half
    and three quarters into its data: the picture is refused as corrupt."""
    sps, pps, samples = stream_units(tmp_path)
    for k, sample in enumerate(samples):
        decoder = decoder_before(sps, pps, samples, k)
        unit = sample[0]
        for cut in (len(unit) // 8, len(unit) // 4, len(unit) // 2, 3 * len(unit) // 4):
            with pytest.raises(ValueError, match=CORRUPT):
                copy.deepcopy(decoder).decode([unit[:max(cut, 2)]] + sample[1:])


def test_bit_flips_decode_or_are_refused_as_corrupt(tmp_path):
    """Single and burst bit flips in every sample's slice data: the picture
    decodes at its size or is refused as corrupt (or, where a flip lands
    in a header field, refused by name)."""
    sps, pps, samples = stream_units(tmp_path)
    rng = np.random.default_rng(5)
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


def test_a_seek_moves_only_the_wanted_picture_to_the_device(tmp_path):
    """Frame 10 of a 12-frame GOP decodes samples 0 to 10 on the host and
    gives (so moves to the device) sample 10's planes alone; out of order,
    the same for the picture of sample 5."""
    for reorder, sample in ((False, 10), (True, 5)):
        path = tmp_path / f"clip_{reorder}.mp4"
        h264.write_h264_mp4(str(path), scene_planes(12, 64, 48), h264.Exerciser(64, 48, 9, gop=12),
                            reorder=reorder)
        capture = VideoCapture(str(path), device="cpu")
        given = list(capture._planes(0, np.array([sample])))
        assert [s for s, _ in given] == [sample]
        _, frames = assert_reads_as_cv2(path)
        index = int(np.flatnonzero(np.concatenate(capture.segments) == sample)[0])
        np.testing.assert_array_equal(capture.to_bgr(*given[0][1]).numpy(), frames[index])


def test_seek_from_the_nearest_idr_picture_reads_as_cv2(tmp_path):
    """With an IDR picture every 5: each frame read alone (decoded from
    the IDR picture before it) equals cv2's read loop."""
    path = tmp_path / "clip.mp4"
    h264.write_h264_mp4(str(path), scene_planes(12, 64, 48), h264.Exerciser(64, 48, 4, gop=5))
    _, frames = assert_reads_as_cv2(path)
    capture = VideoCapture(str(path), device="cpu")
    for index in (0, 4, 5, 7, 11):
        np.testing.assert_array_equal(capture.frame(index).numpy(), frames[index])


def test_without_the_native_library_decode_raises_naming_the_build(tmp_path, monkeypatch):
    """There is no numpy decoder beside the native one: the headers are
    read, then decoding raises, naming why the build failed."""
    path = tmp_path / "clip.mp4"
    h264.write_h264_mp4(str(path), scene_planes(2, 64, 48), h264.Exerciser(64, 48, 1))
    monkeypatch.setattr(native, "get_native_lib", lambda: None)
    monkeypatch.setattr(native, "_build_error", "g++ -c h264_decode.cpp did not run")
    capture = VideoCapture(str(path), device="cpu")
    with pytest.raises(RuntimeError, match="h264_decode.cpp.*did not run"):
        capture.frame(0)
