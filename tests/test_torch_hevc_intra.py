"""HEVC intra pictures decoded by hive_tpu_torch (``native/src/hevc_decode.cpp``)
bit-equal to cv2 5.0.0's frames: chip_smoke.py's VGA exerciser clips
(``video.hevc.Exerciser``, seeded), which together write every syntax path
the writer counts (every intra mode at each transform block size, NxN, the
DST and each DCT size, transform skip, sign data hiding, transquant bypass,
PCM with the loop filter on and off, cu_qp_delta, the chroma QP offsets,
SAO band offsets and the four edge classes, deblocking with offsets and
off across slices, several slices a picture, CTBs of 16, 32 and 64), code
every context an I slice can read and take every loop filter decision the
decoder counts; and the digests by which chip_smoke.py holds the card's
host, which has no cv2. Each clip is read by cv2 three times (its FFmpeg
decodes HEVC on frame threads) before its frames are compared."""

import numpy as np
import pytest

import chip_smoke
from hive_tpu_torch.video import hevc, mp4
from hive_tpu_torch.video.capture import VideoCapture
from tests.test_torch_mpeg4 import assert_reads_as_cv2, cv2_read, scene_planes

# The all-intra clips (the first of HEVC_EXERCISER_CLIPS; the P and B ones
# are tests/test_torch_hevc_inter.py's).
CLIPS = tuple(c for c in chip_smoke.HEVC_EXERCISER_CLIPS if "inter" not in c[3])


@pytest.fixture(scope="module")
def exercisers(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("hevc_exercisers"))
    return [chip_smoke.write_hevc_exerciser(folder, index) for index in range(len(CLIPS))]


@pytest.mark.parametrize("index", range(len(CLIPS)), ids=[c[0] for c in CLIPS])
def test_exerciser_clips_read_as_cv2_and_hash_to_their_digests(exercisers, index):
    """Each exerciser clip: cv2 reads the same frames three times, the port
    reads cv2's frames, and the file and the frames hash to the digests
    chip_smoke.py holds the card's host to."""
    path, _ = exercisers[index]
    name, count = CLIPS[index][:2]
    reads = [cv2_read(path)[1] for _ in range(3)]
    assert all(len(r) == count and all(np.array_equal(a, b) for a, b in zip(r, reads[0]))
               for r in reads[1:])
    _, frames = assert_reads_as_cv2(path, count=count)
    got = (chip_smoke.file_digest(path), chip_smoke.frames_digest(frames))
    assert got == chip_smoke.HEVC_EXERCISER_DIGESTS[name]


def test_exerciser_clips_write_every_path_and_context(exercisers):
    """Over the exerciser clips every path of I slices the writer counts is
    written (each of the 35 luma modes at 4x4, 8x8, 16x16 and 32x32 among
    them), and every context an I slice can read is coded."""
    totals, contexts = {}, np.zeros((3, hevc.NUM_CONTEXTS), np.int64)
    for _, stats in exercisers:
        for name, value in stats.items():
            if name != "contexts":
                totals[name] = totals.get(name, 0) + value
        contexts += stats["contexts"]
    intra = set(hevc.INTRA_STAT_NAMES) | {"pictures", "idr_w_radl", "idr_n_lp", "cra", "trail_r",
                                          "trail_n", "slices", "multi_slice_pictures",
                                          "slice_qp_varies", "slice_sao_off",
                                          "slice_chroma_offsets", "deblocking_override",
                                          "deblocking_off_slices", "deblocking_offsets",
                                          "across_off", "poc_msb_wrap", "sao_ctbs"}
    assert [name for name, value in totals.items() if value == 0 and name in intra] == []
    reach = hevc.contexts_reachable()[0]
    assert np.flatnonzero(reach & (contexts[0] == 0)).tolist() == []
    assert reach.sum() == hevc.INTRA_CONTEXTS - 2 and not contexts[1:].any()


def test_exerciser_clips_take_every_loop_filter_decision(exercisers):
    """Decoding the exerciser clips takes each loop filter decision the
    decoder counts: strong and normal luma filtering, the normal filter's
    second sample, edges left alone, chroma edges, slice edges skipped, PCM
    and bypass samples kept, SAO band and edge offsets, edge samples at the
    picture's border and at a slice boundary left alone."""
    stats = np.zeros(len(hevc.FILTER_NAMES), np.int64)
    for path, _ in exercisers:
        track = mp4.read_track(path)
        length, units = hevc.parse_hvcc(track.config)
        decoder = hevc.HevcDecoder(filter_stats=stats)
        decoder.decode(units)
        with open(path, "rb") as f:
            for offset, size in zip(track.offsets, track.sizes):
                f.seek(int(offset))
                decoder.decode(mp4.split_nal_units(f.read(int(size)), length))
    assert [n for n, v in zip(hevc.FILTER_NAMES, stats) if v == 0] == []


@pytest.mark.parametrize("ctb_log2", [4, 5, 6])
def test_real_picture_planner_reads_as_cv2(tmp_path, ctb_log2):
    """The planner of real pictures (the phone clip's: the intra mode
    nearest each block, SAO and deblocking on, several slices) at each CTB
    size, on the moving test scene, seeked from its CRA pictures."""
    path = tmp_path / "clip.mp4"
    hevc.write_hevc_mp4(str(path), scene_planes(4, 96, 64),
                        hevc.IntraPlanner(96, 64, qp=28, slices=3, cra_every=2),
                        ctb_log2=ctb_log2, max_tb_log2=min(ctb_log2, 5), max_depth_intra=1)
    capture, frames = assert_reads_as_cv2(path, count=4)
    for index in (3, 1):
        np.testing.assert_array_equal(capture.frame(index).numpy(), frames[index])


def test_seek_decodes_from_the_nearest_irap_picture(tmp_path, monkeypatch):
    """A seek to frame 5 of a clip whose IRAP pictures are 0 and 4 decodes
    pictures 4 and 5 only, and reads cv2's frame."""
    path = tmp_path / "clip.mp4"
    hevc.write_hevc_mp4(str(path), scene_planes(7, 64, 48),
                        hevc.IntraPlanner(64, 48, qp=30, cra_every=4))
    _, frames = cv2_read(path)
    capture = VideoCapture(str(path), device="cpu")
    decoded = []
    original = hevc.HevcDecoder.decode

    def counting(self, nal_units):
        picture = original(self, nal_units)
        decoded.append(picture is not None)
        return picture

    monkeypatch.setattr(hevc.HevcDecoder, "decode", counting)
    np.testing.assert_array_equal(capture.frame(5).numpy(), frames[5])
    assert decoded == [False, True, True]          # the parameter sets, then 4 and 5
